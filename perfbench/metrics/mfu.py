"""The model work of every clip the window completed over the window's time
and the card's published peaks: each clip's operations counted from the
configuration's shapes (``work.clip_work``: the detector on each detected
frame at its bucket, the emotion CNN on each crop it computes, the LSTM on
each window, wav2vec2 and the head on each audio window), each type's
operations over its peak (989 TFLOP/s bf16, 1979 TOP/s int8)."""

from perfbench.work import PEAK_FLOPS

LAYER = "device"
UNIT = "%"
MOVES = "video_s_per_s"


def read(obs):
    if not obs.ops or obs.window["seconds"] <= 0:
        return None
    return 100.0 * sum(n / PEAK_FLOPS[k] for k, n in obs.ops.items()) / obs.window["seconds"]
