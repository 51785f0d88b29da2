"""The yardstick's arithmetic: the published peaks of one NVIDIA H100, the
roofline bound of a kernel call, the work of the two fused kernels counted
from a call's shapes and the published widths, the model work of a clip,
and the union of busy intervals.

Copied from ``chip_smoke.py`` (``PEAK_FLOPS``, ``PEAK_BYTES``, ``bound_ms``,
``chain_work``, ``ssh_work``, ``tensor_bytes`` and ``profiled_run``'s busy
union) and made independent of the program: the work is counted from the
input's shape, the blocks and the published bottleneck widths, not through
the port's ``split_folded``, so it is the same whatever implements the call.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from perfbench.reference import models as M

#: NVIDIA H100 SXM data sheet: dense bf16 and int8 on the tensor cores, f32
#: on the CUDA cores, HBM3 bandwidth (at the 700 W power limit)
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, ops: dict) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak of their type."""
    return max(nbytes / PEAK_BYTES, sum(n / PEAK_FLOPS[k] for k, n in ops.items()))


def chain_work(x_shape, blocks, act_bytes: int, int8: bool, out_bytes: int) -> tuple:
    """(bytes, {type: operations}) of one ``fused_chain`` call on NHWC input
    ``x_shape``: the input and every weight read once, the output written
    once, two operations a multiply-add. A block's planes follow ResNet50's
    widths: a "ds" block keeps its input's width, an "s2ds" / "s2pre" entry
    halves it, an "id" block takes a quarter; every block ends at 4 planes."""
    b, h, w, cin = x_shape
    macs = 0
    wbytes = 0
    welt = 1 if int8 else 2
    for kind in blocks:
        planes = cin if kind == "ds" else cin // 2 if kind in ("s2ds", "s2pre") else cin // 4
        cout = 4 * planes
        s2 = kind in ("s2ds", "s2pre")
        ho, wo = ((h + 1) // 2, (w + 1) // 2) if s2 else (h, w)
        px1 = b * h * w if kind == "s2ds" else b * ho * wo  # conv1 at input resolution
        px = b * ho * wo
        convs = [cin * planes, 9 * planes * planes, planes * cout]
        couts = [planes, planes, cout]
        macs += px1 * convs[0] + px * (convs[1] + convs[2])
        if kind != "id":
            convs.append(cin * cout)
            couts.append(cout)
            macs += px * cin * cout
        # the folded scale and shift of each conv: f32 in int8, else the dtype
        wbytes += sum(convs) * welt + sum(couts) * 2 * (4 if int8 else 2)
        h, w, cin = ho, wo, cout
    nbytes = b * x_shape[1] * x_shape[2] * x_shape[3] * act_bytes + out_bytes + wbytes
    return float(nbytes), {"int8" if int8 else "bf16": 2.0 * macs}


def ssh_work(x_shape, leaky: float, lateral: bool, merge: bool, up_bytes: int, int8: bool,
             act_bytes: int, out_bytes: int) -> tuple:
    """(bytes, {type: operations}) of one ``fused_ssh_heads`` call on NHWC
    input ``x_shape``: RetinaFace's widths (256 with ReLU, 64 with leaky ReLU
    0.1), the five SSH convs, the three heads (2 anchors x (4 + 2 + 10)),
    and with the FPN the lateral 1x1 and the merge 3x3. In int8 the convs
    are int8 and the heads stay in the compute dtype."""
    b, h, w, ci = x_shape
    c = 64 if leaky else 256
    q = c // 4
    conv_macs = 9 * (c * c // 2 + c * q + 3 * q * q)
    if lateral:
        conv_macs += ci * c
    if merge:
        conv_macs += 9 * c * c
    head_macs = c * 2 * (4 + 2 + 10)
    px = b * h * w
    welt = 1 if int8 else 2
    nbytes = (px * ci * act_bytes + up_bytes + out_bytes + conv_macs * welt + head_macs * 2)
    kind = "int8" if int8 else "bf16"
    ops = {kind: 2.0 * px * conv_macs}
    ops["bf16"] = ops.get("bf16", 0.0) + 2.0 * px * head_macs
    return float(nbytes), ops


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def idle_gaps(intervals, start: float, stop: float) -> list:
    """The gaps [(start, end)] of ``[start, stop]`` that no interval covers."""
    gaps, end = [], start
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, stop)))
        end = max(end, e)
        if end >= stop:
            break
    if end < stop:
        gaps.append((end, stop))
    return [(a, b) for a, b in gaps if b > a]


# ---------------------------------------------------------------------------
# model work, from the reference's own forward passes on ``meta`` tensors
# ---------------------------------------------------------------------------

class MetaCtx(M.Ctx):
    """A ``models.Ctx`` that hands out zeros on ``meta``: nothing is read or
    computed."""

    def __init__(self, quant=None):
        super().__init__(weights={}, quant=quant)

    def p(self, name, shape, kind, like):
        dtype = torch.long if kind == "count" else torch.float32
        return torch.zeros(shape, dtype=dtype, device="meta")


def _counted(fn, int8: bool) -> dict:
    """{type: operations} of ``fn(ctx)``: the products and convolutions
    PyTorch's flop counter sees, those at the int8 positions (when the stage
    is int8) counted apart."""
    from torch.utils.flop_counter import FlopCounterMode

    quantised = [0.0]

    def hook(op, x, w, b, kw):
        y = op(x, w, b, **kw)
        quantised[0] += 2.0 * y.numel() * w[0].numel()
        return y

    ctx = MetaCtx(hook if int8 else None)
    with FlopCounterMode(display=False) as counter:
        fn(ctx)
    total = float(counter.get_total_flops())
    out = {"bf16": total - quantised[0]}
    if int8:
        out["int8"] = quantised[0]
    return out


@lru_cache(maxsize=None)
def unit_work(serving_items: tuple, families: tuple, hw: tuple) -> dict:
    """Operations of one detected frame, one crop, one LSTM window, one
    exact audio window, and (shared extractor) the encoder and head of one
    window after its features. ``families``: the (role, ``models.Family``)
    pairs of the configuration."""
    from perfbench.reference import pipeline as P

    s, f = dict(serving_items), dict(families)
    q = s["quant"]
    meta = torch.device("meta")
    nh, nw, _ = P.letterbox_size(hw[0], hw[1], s["long_side"])
    crop = torch.zeros(1, 224, 224, 3, device=meta)
    window = torch.zeros(1, 64000, device=meta)
    # the shapes the next stage reads, on ``meta`` outside the counter
    _, feats = f["static"].forward(MetaCtx(), crop)
    audio = f["audio"]
    conv = audio.module.features(MetaCtx(), window, audio.shape)
    return {
        "frame": _counted(lambda c: f["detector"].forward(
            c, torch.zeros(1, nh, nw, 3, device=meta), q), q),
        "crop": _counted(lambda c: f["static"].forward(c, crop, q), q),
        "lstm": _counted(lambda c: f["dynamic"].forward(
            c, torch.zeros(1, 10, feats.shape[-1], device=meta)), False),
        "window": _counted(lambda c: audio.forward(c, window, q), q),
        "window_after_features": _counted(lambda c: audio.module.head(c, audio.module.encode(
            c, torch.zeros_like(conv), audio.shape, q), audio.shape), q),
    }


@lru_cache(maxsize=None)
def extractor_work(samples: int, int8: bool, audio) -> dict:
    """Operations of the audio family's feature extractor over ``samples``."""
    return _counted(lambda c: audio.module.features(
        c, torch.zeros(1, samples, device="meta"), audio.shape, int8), int8)


def clip_work(serving: dict, hw: tuple, n_frames: int, fps: float, n_samples: int,
              families: dict) -> dict:
    """{type: operations} the configuration needs for a clip of ``n_frames``
    frames of ``hw`` (native height, width) in which the face is present
    throughout: the detector on every ``det_stride``-th frame, the CNN on the
    frames it computes, the LSTM on each step frame's window, the audio model
    on each window (with the shared extractor: the extractor once over the
    clip, the rest per full window). ``families``: {role:
    ``models.Family``}."""
    from perfbench.reference import pipeline as P

    unit = unit_work(tuple(sorted(serving.items())), tuple(families.items()), tuple(hw))
    present = np.ones(n_frames, bool)
    step = P.dynamic_step(fps)
    counts = {"frame": -(-n_frames // serving["det_stride"]),
              "crop": len(P.cnn_frames(present, step, serving["cnn_stride"])),
              "lstm": len(P.temporal_plan(present, step)[0])}
    spans = P.audio_windows(n_samples)
    full = sum(e - s >= 64000 for s, e in spans)
    parts = [extractor_work(n_samples + 64001, serving["quant"], families["audio"])] if (
        serving["shared_extractor"] and full) else []
    if serving["shared_extractor"]:
        counts["window_after_features"] = full
        counts["window"] = len(spans) - full
    else:
        counts["window"] = len(spans)
    out: dict = {}
    for name, n in counts.items():
        for kind, ops in unit[name].items():
            out[kind] = out.get(kind, 0.0) + n * ops
    for part in parts:
        for kind, ops in part.items():
            out[kind] = out.get(kind, 0.0) + ops
    return out
