"""Host milliseconds a video-second in the program's span ``detect.upload``
(``DetectStage``'s host -> device copy of each batch's wire), over the
profiled clips: a pageable copy that waits for the card shows here."""

LAYER = "detect"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    p = obs.profile
    spans = [s for s in trace.spans() if s.name == "detect.upload" and s.clip is not None]
    if p is None or not p.video_s or not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / p.video_s
