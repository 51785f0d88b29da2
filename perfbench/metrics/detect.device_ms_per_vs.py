"""Device milliseconds a video-second of the operations launched inside
``DetectStage.dispatch_wire`` (span ``detect.dispatch``: the upload, the I420
rebuild, the network with K3 and K4, decoding, top-64 and NMS), over the
profiled clips."""

LAYER = "detect"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"


def read(obs):
    p = obs.profile
    if p is None or not p.video_s:
        return None
    return 1e3 * p.device_within("detect.dispatch") / p.video_s
