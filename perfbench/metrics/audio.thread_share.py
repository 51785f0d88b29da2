"""The audio thread's wall time over the clips' wall time, over the window:
the sum of ``ClipResult.timings["audio_concurrent"]`` over the sum of
``timings["wall"]``. Below 100 % the audio half overlaps the visual half
with this much headroom before it sets the pace."""

LAYER = "audio"
UNIT = "%"
MOVES = "video_s_per_s"


def read(obs):
    wall = sum(t["wall"] for t in obs.timings)
    if not wall:
        return None
    return 100.0 * sum(t["audio_concurrent"] for t in obs.timings) / wall
