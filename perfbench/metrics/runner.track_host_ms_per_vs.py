"""Host milliseconds a video-second in ``DetectStage.unpack`` and the clip's
tracker (spans ``runner.unpack`` and ``runner.track``), over the window: the
per-detected-frame Python of the detect stage's host loop."""

LAYER = "runner"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"


def read(obs):
    if "runner.unpack" not in obs.host or not obs.window["video_s"]:
        return None
    host = obs.host["runner.unpack"] + obs.host.get("runner.track", 0.0)
    return 1e3 * host / obs.window["video_s"]
