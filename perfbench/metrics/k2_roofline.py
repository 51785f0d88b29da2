"""K2 (``mha``, the audio encoder's attention) over the profiled clips: the
sum over the program's ``k2`` spans of each call's roofline bound (the
larger of its bytes over 3.35 TB/s and its operations over the peak of
their type, counted from the span's shapes by ``k2_work``) over the sum of
the device time of K2's kernels, taken by name (the audio stream's
operations are not taken by launching span). The work is the same whatever
implements the bias: a bias formed in device memory pays its bytes as lost
share. Nothing is read from a program without ``k2`` spans."""

from perfbench.work import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "video_s_per_s"
#: K2's kernels (``csrc/attention.cu``)
KERNELS = ("mha_tc_kernel", "mha_tc_bias_kernel", "mha_exact_kernel")


def k2_work(attrs: dict) -> tuple:
    """(bytes, {type: operations}) of one K2 call from its span's attributes:
    Q, K, V and O once, with a bias its gate, table and bucket map;
    4 BH T^2 D operations in the operands' type (two products) and, with a
    bias, 2 BH T^2 in f32 (a multiply and an add a logit)."""
    bh, t, d = attrs["bh"], attrs["t"], attrs["d"]
    bf16 = "bfloat16" in attrs["dtype"]
    nbytes = 4 * bh * t * d * (2 if bf16 else 4)
    ops = {"bf16" if bf16 else "f32": 4.0 * bh * t * t * d}
    if attrs["bias"]:
        nbytes += 4 * (bh * t + attrs["heads"] * attrs["nb"] + 2 * t - 1)
        ops["f32"] = ops.get("f32", 0.0) + 2.0 * bh * t * t
    return float(nbytes), ops


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    p = obs.profile
    calls = [s for s in trace.spans() if s.name == "k2" and s.clip is not None
             and {"bh", "t", "d", "heads", "nb"} <= set(s.attrs)]
    if p is None or not calls:
        return None
    device = sum(e - s for s, e, name, *_ in p.device if any(k in name for k in KERNELS))
    if device <= 0:
        return None
    return 100.0 * sum(bound_s(*k2_work(s.attrs)) for s in calls) / device
