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

Dispatch rule, with no fallback: a CPU tensor goes to
``fused_ssh_heads_plain``; a CUDA tensor launches the kernel (one launch per
call) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from avcer_tpu_torch import _build
from avcer_tpu_torch.ops.cuda.fused_resnet_kernel import (BLOCKS_PER_SM, DTYPE_CODE,
                                                          REGION_PIXELS, check_cuda_tensor,
                                                          conv_bn_plain, conv_bn_plain_q,
                                                          tile_edge)


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


def activate(y: torch.Tensor, leaky: float) -> torch.Tensor:
    """ReLU, or leaky ReLU with the slope rounded to ``y``'s dtype and the
    product taken in it: the kernel's rule and the JAX package's."""
    if leaky == 0.0:
        return F.relu(y)
    return torch.where(y >= 0, y, y * torch.tensor(leaky, dtype=y.dtype, device=y.device))


def fused_ssh_heads_plain(
    x: torch.Tensor, conv_folded: Sequence[torch.Tensor], head_folded: Sequence[torch.Tensor],
    leaky: float = 0.0, fpn_lat: Optional[Sequence[torch.Tensor]] = None,
    fpn_merge: Optional[Sequence[torch.Tensor]] = None, up: Optional[torch.Tensor] = None,
    emit_feature: bool = False, band: int = 32, act_s=None,
) -> tuple[torch.Tensor, ...]:
    """The scale in plain PyTorch (``F.conv2d`` on NCHW views, f32
    accumulation or, with ``act_s``, exact integer sums in the convs; the
    kernel's rounding points)."""
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
             sm_count: int, q_ci: int = 0) -> dict[str, int]:
    """Tiling of one call, as ``csrc/fused_ssh.cu`` derives it again from
    ``th``, ``tw``, ``g`` and ``grid``. ``q_ci``: with the int8 option the
    input's channels (each thread block then also holds an int8 plane of its
    widest conv input), else 0."""
    th, tw = tile_edge(h), tile_edge(w)
    halo = 4 if has_merge else 3
    rh, rw = th + 2 * halo, tw + 2 * halo
    g = max(1, min(b, REGION_PIXELS // (rh * rw)))
    nwork = -(-b // g) * -(-h // th) * -(-w // tw)
    grid = max(1, min(nwork, BLOCKS_PER_SM * sm_count))
    slab = g * rh * rw * (c * (3 if has_merge else 2) + c // 2)
    qslab = g * rh * rw * max(q_ci, c) if q_ci else 0
    return {"th": th, "tw": tw, "halo": halo, "g": g, "nwork": nwork, "grid": grid,
            "scratch_bytes": (slab * itemsize + qslab) * grid}


def fused_ssh_heads(
    x: torch.Tensor, conv_folded: Sequence[torch.Tensor], head_folded: Sequence[torch.Tensor],
    leaky: float = 0.0, fpn_lat: Optional[Sequence[torch.Tensor]] = None,
    fpn_merge: Optional[Sequence[torch.Tensor]] = None, up: Optional[torch.Tensor] = None,
    emit_feature: bool = False, band: int = 32, act_s=None,
) -> tuple[torch.Tensor, ...]:
    """One FPN scale: optional lateral + top-down add + merge, the SSH
    module, the three heads; with ``act_s`` the convs in int8. ``band`` is the
    TPU kernel's VMEM tiling and is ignored by the CUDA kernel.
    ``fused_ssh_heads.launches`` counts kernel launches, and
    ``fused_ssh_heads.launches_by_leaky`` the same launches by their slope."""
    if x.device.type == "cpu":
        return fused_ssh_heads_plain(x, conv_folded, head_folded, leaky, fpn_lat, fpn_merge,
                                     up, emit_feature, band, act_s)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ssh_heads: unsupported device {x.device}")
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
    for j, t in enumerate(conv_weights):
        want = None if not quant else (torch.int8 if j % 3 == 0 else torch.float32)
        check_cuda_tensor("fused_ssh_heads", t, x, want)
    for t in head_folded:
        check_cuda_tensor("fused_ssh_heads", t, x)
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
        act_s = act_s.to(device=x.device, dtype=torch.float32).contiguous()
    if up is not None:
        if fpn_lat is None:
            raise ValueError("fused_ssh_heads: up requires fpn_lat")
        up = up.to(x.dtype)
        if tuple(up.shape) != (b, h, w, c) or up.device != x.device or not up.is_contiguous():
            raise ValueError(
                f"fused_ssh_heads: up must be contiguous [{b}, {h}, {w}, {c}] on {x.device}, "
                f"got {tuple(up.shape)}")
    head_n = [hw.shape[1] for hw in head_folded[0::2]]
    outs = [torch.empty((b, h, w, n), dtype=x.dtype, device=x.device) for n in head_n]
    if emit_feature:
        outs.append(torch.empty((b, h, w, c), dtype=x.dtype, device=x.device))
    if b == 0:
        return tuple(outs)
    props = torch.cuda.get_device_properties(x.device)
    plan = ssh_plan(b, h, w, c, fpn_merge is not None, x.element_size(),
                    props.multi_processor_count, q_ci=ci if quant else 0)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=x.device)
    ptrs = ([t.data_ptr() for t in fpn_lat] if fpn_lat is not None else [None] * 3)
    ptrs += ([t.data_ptr() for t in fpn_merge] if fpn_merge is not None else [None] * 3)
    ptrs += [t.data_ptr() for t in conv_folded] + [t.data_ptr() for t in head_folded]
    out_ptrs = [o.data_ptr() for o in outs] + ([None] if not emit_feature else [])
    lib = _build.library("fused_ssh")
    fn = lib.avcer_fused_ssh_q if quant else lib.avcer_fused_ssh
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * (2 if quant else 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), up.data_ptr() if up is not None else None,
                (ctypes.c_void_p * 27)(*ptrs), (ctypes.c_int * 3)(*head_n),
                (ctypes.c_void_p * 4)(*out_ptrs), scratch.data_ptr(), plan["scratch_bytes"],
                b, h, w, ci, c, float(leaky), plan["th"], plan["tw"], plan["g"], plan["grid"],
                DTYPE_CODE[x.dtype], *((act_s.data_ptr(),) if quant else ()), stream)
    if rc != 0:
        raise RuntimeError(f"fused_ssh_heads kernel launch failed: CUDA error {rc}")
    fused_ssh_heads.launches += 1
    by_leaky = fused_ssh_heads.launches_by_leaky
    by_leaky[float(leaky)] = by_leaky.get(float(leaky), 0) + 1
    return tuple(outs)


fused_ssh_heads.launches = 0
fused_ssh_heads.launches_by_leaky = {}
