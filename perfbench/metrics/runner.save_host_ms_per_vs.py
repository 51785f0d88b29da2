"""Host milliseconds a video-second in the program's span ``runner.save``
(the CSVs and the compound txt of each clip, written on the serving
thread), over the profiled clips."""

LAYER = "runner"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    p = obs.profile
    spans = [s for s in trace.spans() if s.name == "runner.save" and s.clip is not None]
    if p is None or not p.video_s or not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / p.video_s
