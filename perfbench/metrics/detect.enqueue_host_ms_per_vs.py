"""Host milliseconds a video-second in the program's spans
``detect.network`` and ``detect.decode`` (enqueuing the detector: the
network with K3 and K4, decoding, top-64, NMS, the pack), over the profiled
clips. Enqueuing costs far less than the device time it enqueues; a hidden
synchronise shows here as host time near the device's."""

LAYER = "detect"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"
SPANS = ("detect.network", "detect.decode")


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    p = obs.profile
    spans = [s for s in trace.spans() if s.name in SPANS and s.clip is not None]
    if p is None or not p.video_s or not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / p.video_s
