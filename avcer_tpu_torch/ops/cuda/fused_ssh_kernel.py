"""Wrapper of the CUDA FPN + SSH + heads kernel (``csrc/fused_ssh.cu``), the
counterpart of avcer_tpu/ops/pallas/fused_ssh_kernel.py ``fused_ssh_heads``.

Arguments and return order as the JAX function's: ``x`` ``[B, H, W, Ci]``
NHWC (the scale's FPN feature or, with ``fpn_lat``, the raw backbone
feature); ``conv_folded`` 5 x ``(w [3, 3, ci, co], inv, shift)`` for conv3X3,
conv5X5_1, conv5X5_2, conv7X7_2, conv7x7_3; ``head_folded`` 3 x ``(w [C, out],
bias)`` for the box, class and landmark heads; ``fpn_lat`` ``(w [Ci, C], inv,
shift)``; ``fpn_merge`` ``(w [3, 3, C, C], inv, shift)``; ``up`` ``[B, H, W,
C]`` the upsampled coarser level. Returns ``(loc, conf, landmarks)`` as
``[B, H, W, out]`` and, with ``emit_feature``, the scale's FPN feature.

The int8 option (``act_s``), as the JAX function's: the lateral, the merge and
the five SSH convs hold ``(wq int8, mult f32, shift f32)`` with ``mult = sx *
sw * bn_inv``, ``act_s`` their static activation scales in the order lateral,
merge, then the five SSH convs; the heads stay exact in the compute dtype.
The kernel's int8 product reads each ``wq`` packed ``[taps, co, ci]``
(``pack_chain_q`` of the lateral, merge and SSH folds, in that order): a
caller that folds once packs once and hands the copy in as ``packed``;
without it a CUDA call packs its own.

Dispatch rule, with no fallback: a CPU tensor goes to
``fused_ssh_heads_plain``; a CUDA tensor launches the kernel (one launch per
call) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from avcer_tpu_torch import _build
from avcer_tpu_torch.ops.cuda.fused_resnet_kernel import (DTYPE_CODE, MAX_CLUSTER,
                                                          REGION_PIXELS, card_occupancy,
                                                          check_cuda_tensor, conv_bn_plain,
                                                          conv_bn_plain_q, pack_chain_q,
                                                          packed_shape, tile_edge)
from avcer_tpu_torch.utils import trace


def _check_args(conv_folded, head_folded, fpn_lat, fpn_merge, act_s) -> None:
    if fpn_merge is not None and fpn_lat is None:
        raise ValueError("fpn_merge requires fpn_lat")
    if len(conv_folded) != 15 or len(head_folded) != 6:
        raise ValueError(
            f"fused_ssh_heads: expected 5 x (w, inv, shift) and 3 x (w, bias), got "
            f"{len(conv_folded)} and {len(head_folded)} tensors")
    n_scales = 5 + (fpn_lat is not None) + (fpn_merge is not None)
    if act_s is not None and tuple(act_s.shape) != (n_scales,):
        raise ValueError(
            f"fused_ssh_heads: act_s must hold one scale per conv ({n_scales}), got "
            f"{tuple(act_s.shape)}")


def kernel_conv_weights(conv_weights: Sequence[torch.Tensor],
                        packed: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The int8 option's conv tensors as the kernel reads them:
    ``conv_weights`` (the flat ``(wq, mult, shift)`` of the lateral, the merge
    and the five SSH convs that the call has, in that order) with each ``wq``
    replaced by its copy in ``packed``. Raises ``ValueError`` unless
    ``packed`` is ``pack_chain_q`` of those folds: one int8 ``[taps, co, ci]``
    tensor a conv, no more and no fewer."""
    out = list(conv_weights)
    if len(packed) != len(out) // 3:
        raise ValueError(f"fused_ssh_heads: {len(packed)} packed weights for "
                         f"{len(out) // 3} convs")
    for j, p in zip(range(0, len(out), 3), packed):
        if p.dtype != torch.int8 or p.shape != packed_shape(out[j]):
            raise ValueError(f"fused_ssh_heads: packed weights {tuple(p.shape)} {p.dtype} are "
                             f"not pack_chain_q of the fold {tuple(out[j].shape)}")
        out[j] = p
    return out


#: the leaky slopes by (slope, dtype, device), each made once: a new one at
#: every call is a host-to-device copy, which waits for the stream and which
#: a graph's capture refuses
_SLOPES: dict = {}


def activate(y: torch.Tensor, leaky: float) -> torch.Tensor:
    """ReLU, or leaky ReLU with the slope rounded to ``y``'s dtype and the
    product taken in it: the kernel's rule and the JAX package's."""
    if leaky == 0.0:
        return F.relu(y)
    key = (leaky, y.dtype, y.device)
    slope = _SLOPES.get(key)
    if slope is None:
        with torch.inference_mode(False):  # usable where autograd records too
            slope = _SLOPES[key] = torch.tensor(leaky, dtype=y.dtype, device=y.device)
    return torch.where(y >= 0, y, y * slope)


def fused_ssh_heads_plain(
    x: torch.Tensor, conv_folded: Sequence[torch.Tensor], head_folded: Sequence[torch.Tensor],
    leaky: float = 0.0, fpn_lat: Optional[Sequence[torch.Tensor]] = None,
    fpn_merge: Optional[Sequence[torch.Tensor]] = None, up: Optional[torch.Tensor] = None,
    emit_feature: bool = False, band: int = 32, act_s=None,
    packed: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, ...]:
    """The scale in plain PyTorch (``F.conv2d`` on NCHW views, f32
    accumulation or, with ``act_s``, exact integer sums in the convs; the
    kernel's rounding points). It reads the folds in the JAX layout;
    ``packed`` (the kernel's copy of the int8 weights) is taken for the
    wrapper's signature and not read."""
    _check_args(conv_folded, head_folded, fpn_lat, fpn_merge, act_s)
    scales = iter(act_s) if act_s is not None else None

    def conv(h, t):
        if scales is None:
            return conv_bn_plain(h, *t)
        return conv_bn_plain_q(h, next(scales), *t)

    f = x.permute(0, 3, 1, 2)
    if fpn_lat is not None:
        f = activate(conv(f, fpn_lat), leaky)
    if up is not None:
        f = f + up.to(x.dtype).permute(0, 3, 1, 2)
    if fpn_merge is not None:
        f = activate(conv(f, fpn_merge), leaky)
    cf = conv_folded
    c3 = conv(f, cf[0:3])
    c5_1 = activate(conv(f, cf[3:6]), leaky)
    c5 = conv(c5_1, cf[6:9])
    c7 = conv(activate(conv(c5_1, cf[9:12]), leaky), cf[12:15])
    cat = F.relu(torch.cat([c3, c5, c7], dim=1)).permute(0, 2, 3, 1).float()
    outs = tuple((torch.matmul(cat, w.float()).to(x.dtype) + b.reshape(-1))
                 for w, b in zip(head_folded[0::2], head_folded[1::2]))
    if emit_feature:
        outs += (f.permute(0, 2, 3, 1).contiguous(),)
    return outs


def ssh_plan(b: int, h: int, w: int, c: int, has_merge: bool, itemsize: int,
             held: Mapping[int, int], q_ci: int = 0,
             cluster: Optional[int] = None) -> dict[str, int]:
    """Tiling of one call, as ``csrc/fused_ssh.cu`` derives it again from
    ``th``, ``tw``, ``g``, ``grid`` and ``cluster``: tile, halo, frames per
    work item, the cluster size ``C``, the grid and the scratch.

    A cluster of C thread blocks works on one work item at a time. ``held[C]``
    is how many clusters of C blocks the card holds at once (what
    ``ssh_occupancy`` reports). C is the size from 1 to ``MAX_CLUSTER`` with
    the fewest rounds of work items a block, ``ceil(nwork / held[C]) / C``,
    ties to the smaller C; the grid is ``min(nwork, held[C])`` clusters, and
    the scratch holds one slab per cluster. ``q_ci``: with the int8 option
    the input's channels (each slab then also holds an int8 plane of its
    widest conv input), else 0. ``cluster`` overrides C (the card tests force
    it).

    ``depths`` and ``rows``: each conv's depth d, and the pixels of a work
    item it computes, ``g * (rh - 2d) * (rw - 2d)``: the region less d pixels
    on every side, what the next step reads (``lateral`` is the copy of the
    input where there is no lateral)."""
    th, tw = tile_edge(h), tile_edge(w)
    halo = 4 if has_merge else 3
    rh, rw = th + 2 * halo, tw + 2 * halo
    g = max(1, min(b, REGION_PIXELS // (rh * rw)))
    nwork = -(-b // g) * -(-h // th) * -(-w // tw)
    cl = cluster or min(range(1, MAX_CLUSTER + 1),
                        key=lambda n: (-(-nwork // held[n]) / n, n))
    clusters = max(1, min(nwork, held[cl]))
    slab = g * rh * rw * (c * (3 if has_merge else 2) + c // 2)
    qslab = g * rh * rw * max(q_ci, c) if q_ci else 0
    d0 = halo - 3  # where f is exact: after the merge, or the lateral's own output
    depths = {"lateral": 0, **({"merge": 1} if has_merge else {}), "c3": halo,
              "c5_1": d0 + 1, "c5": halo, "c7_2": d0 + 2, "c7": halo}
    return {"th": th, "tw": tw, "halo": halo, "g": g, "nwork": nwork, "cluster": cl,
            "grid": clusters * cl, "scratch_bytes": (slab * itemsize + qslab) * clusters,
            "depths": depths,
            "rows": {k: g * (rh - 2 * d) * (rw - 2 * d) for k, d in depths.items()}}


def ssh_occupancy(device: torch.device, dtype: torch.dtype, quant: bool,
                  cluster: int) -> dict[str, int]:
    """``card_occupancy`` of this kernel (int8 option if ``quant``), kept in
    ``fused_ssh_heads.occupancy``."""
    return card_occupancy("fused_ssh", "fused_ssh", fused_ssh_heads.occupancy, device, dtype,
                          quant, cluster)


def card_plan(x: torch.Tensor, c: int, has_merge: bool, quant: bool,
              cluster: Optional[int] = None) -> dict[str, int]:
    """``ssh_plan`` for a call on ``x``'s card, with what the card holds of
    each cluster size, and the clusters it holds of the chosen one
    (``max_active_clusters``)."""
    b, h, w, ci = x.shape
    sizes = (cluster,) if cluster else range(1, MAX_CLUSTER + 1)
    held = {n: ssh_occupancy(x.device, x.dtype, quant, n)["clusters"] for n in sizes}
    plan = ssh_plan(b, h, w, c, has_merge, x.element_size(), held, q_ci=ci if quant else 0,
                    cluster=cluster)
    plan["max_active_clusters"] = held[plan["cluster"]]
    return plan


def fused_ssh_heads(
    x: torch.Tensor, conv_folded: Sequence[torch.Tensor], head_folded: Sequence[torch.Tensor],
    leaky: float = 0.0, fpn_lat: Optional[Sequence[torch.Tensor]] = None,
    fpn_merge: Optional[Sequence[torch.Tensor]] = None, up: Optional[torch.Tensor] = None,
    emit_feature: bool = False, band: int = 32, act_s=None,
    packed: Optional[Sequence[torch.Tensor]] = None,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, ...]:
    """One FPN scale: optional lateral + top-down add + merge, the SSH
    module, the three heads; with ``act_s`` the convs in int8. ``band`` is the
    TPU kernel's VMEM tiling and is ignored by the CUDA kernel. ``packed``:
    ``pack_chain_q`` of the int8 lateral, merge and SSH folds the call has,
    made once by a caller that keeps its folds (else the int8 option packs on
    every CUDA call). ``out``: tensors like the results to write them into
    (a replay of piecewise graphs hands the ones its graphs read).
    ``fused_ssh_heads.launches`` counts kernel launches,
    ``fused_ssh_heads.launches_by_leaky`` the same launches by their slope,
    and ``fused_ssh_heads.occupancy`` holds what the card reported for each
    launch configuration (see ``ssh_occupancy``). While a profiler records,
    each call is the span ``k4`` (``utils.trace``)."""
    with trace.span("k4") as sp:
        if sp:
            sp.note(shape=tuple(x.shape), dtype=str(x.dtype), int8=act_s is not None)
        if x.device.type == "cpu":
            res = fused_ssh_heads_plain(x, conv_folded, head_folded, leaky, fpn_lat,
                                        fpn_merge, up, emit_feature, band, act_s)
            return res if out is None else tuple(o.copy_(r) for o, r in zip(out, res))
        if x.device.type != "cuda":
            raise ValueError(f"fused_ssh_heads: unsupported device {x.device}")
        return _fused_ssh_cuda(x, conv_folded, head_folded, leaky, fpn_lat, fpn_merge, up,
                               emit_feature, act_s, packed=packed, out=out)


def _fused_ssh_cuda(x: torch.Tensor, conv_folded: Sequence[torch.Tensor],
                    head_folded: Sequence[torch.Tensor], leaky: float = 0.0,
                    fpn_lat: Optional[Sequence[torch.Tensor]] = None,
                    fpn_merge: Optional[Sequence[torch.Tensor]] = None,
                    up: Optional[torch.Tensor] = None, emit_feature: bool = False, act_s=None,
                    cluster: Optional[int] = None,
                    packed: Optional[Sequence[torch.Tensor]] = None,
                    out: Optional[Sequence[torch.Tensor]] = None) -> tuple[torch.Tensor, ...]:
    """The launch behind ``fused_ssh_heads`` for a CUDA tensor; ``cluster``
    forces the cluster size instead of the plan's (the card tests compare
    sizes with it). A cluster the card refuses raises: nothing retries with
    another size. The int8 option launches on ``packed`` (packed here when
    not given). ``out``: the results' tensors, made here when not given."""
    _check_args(conv_folded, head_folded, fpn_lat, fpn_merge, act_s)
    if x.dim() != 4 or x.dtype not in DTYPE_CODE or not x.is_contiguous():
        raise ValueError(
            f"fused_ssh_heads: x must be contiguous [B, H, W, C] float32 or bfloat16, got "
            f"{tuple(x.shape)} {x.dtype}")
    b, h, w, ci = x.shape
    c = fpn_lat[0].shape[-1] if fpn_lat is not None else conv_folded[0].shape[-2]
    quant = act_s is not None
    vec = 16 // x.element_size()
    conv_weights = list(fpn_lat or ()) + list(fpn_merge or ()) + list(conv_folded)
    weights = conv_weights + list(head_folded)
    q = c // 4
    shapes_ok = (
        [tuple(t.shape) for t in conv_folded[0::3]]
        == [(3, 3, c, c // 2), (3, 3, c, q), (3, 3, q, q), (3, 3, q, q), (3, 3, q, q)]
        and all(hw.dim() == 2 and hw.shape[0] == c and hb.numel() == hw.shape[1]
                for hw, hb in zip(head_folded[0::2], head_folded[1::2]))
        and (fpn_lat is None or tuple(fpn_lat[0].shape) == (ci, c))
        and (fpn_lat is not None or ci == c)
        and (fpn_merge is None or tuple(fpn_merge[0].shape) == (3, 3, c, c)))
    c_align = 64 if quant else 4 * vec  # int8 weights are copied 16 channels at a time
    if not shapes_ok or c % c_align or ci % (16 if quant else vec):
        raise ValueError(
            f"fused_ssh_heads: weights {[tuple(t.shape) for t in weights]} do not fit input "
            f"channels {ci}, feature channels {c} (C must be a multiple of {c_align})")
    if quant:
        conv_weights = kernel_conv_weights(
            conv_weights, pack_chain_q(conv_weights) if packed is None else packed)
        act_s = act_s.to(device=x.device, dtype=torch.float32).contiguous()
    for j, t in enumerate(conv_weights):
        want = None if not quant else (torch.int8 if j % 3 == 0 else torch.float32)
        check_cuda_tensor("fused_ssh_heads", t, x, want)
    for t in head_folded:
        check_cuda_tensor("fused_ssh_heads", t, x)
    if up is not None:
        if fpn_lat is None:
            raise ValueError("fused_ssh_heads: up requires fpn_lat")
        up = up.to(x.dtype)
        if tuple(up.shape) != (b, h, w, c) or up.device != x.device or not up.is_contiguous():
            raise ValueError(
                f"fused_ssh_heads: up must be contiguous [{b}, {h}, {w}, {c}] on {x.device}, "
                f"got {tuple(up.shape)}")
    head_n = [hw.shape[1] for hw in head_folded[0::2]]
    shapes = [(b, h, w, n) for n in head_n] + ([(b, h, w, c)] if emit_feature else [])
    if out is None:
        outs = [torch.empty(shape, dtype=x.dtype, device=x.device) for shape in shapes]
    else:
        outs = list(out)
        if [tuple(o.shape) for o in outs] != shapes or not all(
                o.dtype == x.dtype and o.device == x.device and o.is_contiguous()
                for o in outs):
            raise ValueError(f"fused_ssh_heads: out must be contiguous {shapes} "
                             f"{x.dtype} on {x.device}")
    if b == 0:
        return tuple(outs)
    plan = card_plan(x, c, fpn_merge is not None, quant, cluster)
    trace.annotate("k4", C=plan["cluster"], grid=plan["grid"])
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=x.device)
    # (w, inv, shift) of the lateral and the merge (null where absent), the SSH
    # convs', then the heads'
    convs = iter(conv_weights)
    ptrs = [next(convs).data_ptr() if present else None
            for present in (fpn_lat is not None, fpn_merge is not None) for _ in range(3)]
    ptrs += [t.data_ptr() for t in convs] + [t.data_ptr() for t in head_folded]
    out_ptrs = [o.data_ptr() for o in outs] + ([None] if not emit_feature else [])
    lib = _build.library("fused_ssh")
    fn = lib.avcer_fused_ssh_q if quant else lib.avcer_fused_ssh
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * (2 if quant else 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), up.data_ptr() if up is not None else None,
                (ctypes.c_void_p * 27)(*ptrs), (ctypes.c_int * 3)(*head_n),
                (ctypes.c_void_p * 4)(*out_ptrs), scratch.data_ptr(), plan["scratch_bytes"],
                b, h, w, ci, c, float(leaky), plan["th"], plan["tw"], plan["g"], plan["grid"],
                plan["cluster"], DTYPE_CODE[x.dtype], *((act_s.data_ptr(),) if quant else ()),
                stream)
    if rc != 0:
        raise RuntimeError(f"fused_ssh_heads kernel launch failed: CUDA error {rc}")
    trace.launched(fused_ssh_heads, launches_by_leaky=float(leaky))
    return tuple(outs)


fused_ssh_heads.launches = 0
fused_ssh_heads.launches_by_leaky = {}
fused_ssh_heads.occupancy = {}
