"""Device milliseconds a video-second of the operations launched inside
``VisualStage.run_static_from_frames`` and ``run_dynamic`` (spans
``visual.static``, ``visual.dynamic``: crops, the emotion CNN with K3, the
LSTM), over the profiled clips."""

LAYER = "visual"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"


def read(obs):
    p = obs.profile
    if p is None or not p.video_s:
        return None
    return 1e3 * p.device_within("visual.", prefix=True) / p.video_s
