"""The bytes of the detect stage's uploads (the program's counter
``detect.upload_bytes``) over the host seconds in its span
``detect.upload``, over the profiled clips: what one copy moves a second,
against the tens of GB/s a pinned copy reaches on the host link."""

LAYER = "detect"
UNIT = "GB/s"
MOVES = "video_s_per_s"


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    seconds = sum(s.seconds for s in trace.spans()
                  if s.name == "detect.upload" and s.clip is not None)
    nbytes = sum(c.counts.get("detect.upload_bytes", 0) for c in trace.clips())
    if obs.profile is None or seconds <= 0 or not nbytes:
        return None
    return nbytes / seconds * 1e-9
