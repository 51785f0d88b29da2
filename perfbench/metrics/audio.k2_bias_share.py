"""The share of the profiled clips' K2 calls that took the relative position
bias (the program's counters ``k2.bias_calls`` over ``k2.calls``): a WavLM
layer's attention on K2's bias mode. It guards the route, as
``detect.graph_share`` does: below 100 % some layer's attention left the
kernel's bias mode. Nothing is read from a program without those
counters."""

LAYER = "audio"
UNIT = "%"
MOVES = "video_s_per_s"


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    if obs.profile is None:
        return None
    calls = biased = 0
    for c in trace.clips():
        calls += c.counts.get("k2.calls", 0)
        biased += c.counts.get("k2.bias_calls", 0)
    if calls == 0:
        return None
    return 100.0 * biased / calls
