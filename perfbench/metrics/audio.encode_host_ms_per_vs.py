"""Host milliseconds a video-second in the program's span ``audio.encode``
(the audio encoder's forward of one batch of windows on the audio worker:
enqueuing the extractor, the layers and their K2 calls), over the profiled
clips. It shows how much of the audio worker's time is the host's enqueue
rather than the card's work. Nothing is read from a program without that
span."""

LAYER = "audio"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    p = obs.profile
    spans = [s for s in trace.spans() if s.name == "audio.encode" and s.clip is not None]
    if p is None or not p.video_s or not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / p.video_s
