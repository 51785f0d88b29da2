"""Wrapper of the CUDA bottleneck-chain kernel (``csrc/fused_resnet.cu``), the
counterpart of avcer_tpu/ops/pallas/fused_resnet_kernel.py ``fused_chain`` and
``fused_layer1``.

Public layout as the JAX function's: ``x`` is ``[B, H, W, Cin]`` NHWC;
``folded`` is the flat tuple of ``(w, inv, shift)`` per conv (conv1, conv2,
conv3 and, for a projection block, the projection), ``w`` matmul-shaped
``[ci, co]`` for a 1x1 and ``[3, 3, ci, co]`` for the 3x3, ``inv`` and
``shift`` the folded BatchNorm ``[1, C]``; ``blocks`` is a tuple of ``"ds" |
"id" | "s2ds" | "s2pre"``.

Dispatch rule, with no fallback: a CPU tensor goes to ``fused_chain_plain``;
a CUDA tensor launches the kernel (one launch per call) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from avcer_tpu_torch import _build

KINDS = {"id": 0, "ds": 1, "s2ds": 2, "s2pre": 3}
MAX_BLOCKS = 6
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: resident thread blocks per SM the persistent grid is sized for
BLOCKS_PER_SM = 2
#: a work item gathers frames until its region has about this many pixels
REGION_PIXELS = 256


def conv_bn_plain(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """Folded conv + BatchNorm on NCHW ``x`` with the kernels' rounding
    points: products accumulated in f32, the sum rounded to ``x``'s dtype,
    then ``* inv`` and ``+ shift`` in that dtype (two roundings in bf16). ``w``
    is ``[ci, co]`` (1x1, no padding) or ``[3, 3, ci, co]`` (padding 1)."""
    if w.dim() == 2:
        weight, pad = w.t()[:, :, None, None], 0
    else:
        weight, pad = w.permute(3, 2, 0, 1), 1
    y = F.conv2d(x.float(), weight.float(), stride=stride, padding=pad).to(x.dtype)
    return y * inv.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)


def split_folded(folded: Sequence[torch.Tensor], blocks: Sequence[str]) -> list[list[torch.Tensor]]:
    """The flat ``folded`` tuple cut into one list of 9 ("id") or 12 tensors
    per block."""
    out, i = [], 0
    for kind in blocks:
        take = 9 if kind == "id" else 12
        out.append(list(folded[i:i + take]))
        i += take
    if i != len(folded) or any(len(b) not in (9, 12) for b in out):
        raise ValueError(f"fused_chain: {len(folded)} folded tensors do not fit blocks {blocks}")
    return out


def _check_blocks(blocks: Sequence[str], act_s) -> None:
    if act_s is not None:
        raise NotImplementedError(
            "fused_chain: the int8 mode (act_s) is not ported; it comes with int8 "
            "serving (ROADMAP queue 1 item 11)")
    if not blocks or any(b not in KINDS for b in blocks):
        raise ValueError(f"fused_chain: unknown block kinds in {blocks}")
    if any(b in ("s2ds", "s2pre") for b in blocks[1:]) or (
            blocks[0] in ("s2ds", "s2pre") and any(b != "id" for b in blocks[1:])):
        raise ValueError("a stride-2 entry must be the single entry block")


def fused_chain_plain(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: Sequence[str],
                      band: int = 32, act_s=None) -> torch.Tensor:
    """The chain in plain PyTorch (``F.conv2d`` on NCHW views, f32
    accumulation, the kernel's rounding points). NHWC in, NHWC out."""
    _check_blocks(blocks, act_s)
    h = x.permute(0, 3, 1, 2)
    for kind, t in zip(blocks, split_folded(folded, blocks)):
        s1 = 2 if kind == "s2pre" else 1  # TF v1: the stride on conv1
        s2 = 2 if kind == "s2ds" else 1  # torchvision v1.5: on the 3x3
        res = h if kind == "id" else conv_bn_plain(h, *t[9:12], stride=s1 * s2)
        y = F.relu(conv_bn_plain(h, *t[0:3], stride=s1))
        y = F.relu(conv_bn_plain(y, *t[3:6], stride=s2))
        h = F.relu(conv_bn_plain(y, *t[6:9]) + res)
    return h.permute(0, 2, 3, 1).contiguous()


def tile_edge(dim: int) -> int:
    """Tile edge: a small frame is one tile; a large one is cut evenly into
    tiles of at most 24."""
    return dim if dim <= 32 else -(-dim // -(-dim // 24))


def chain_plan(b: int, h: int, w: int, cout: int, planes_max: int, blocks: Sequence[str],
               itemsize: int, sm_count: int) -> dict[str, int]:
    """Tiling of one call, as ``csrc/fused_resnet.cu`` derives it again from
    ``th``, ``tw``, ``g`` and ``grid``: output size, tile, halo, frames per
    work item, grid, and the scratch the thread blocks need."""
    s2 = blocks[0] in ("s2ds", "s2pre")
    ho, wo = ((h + 1) // 2, (w + 1) // 2) if s2 else (h, w)
    th, tw = tile_edge(ho), tile_edge(wo)
    halo = len(blocks) - 1 if blocks[0] == "s2ds" else len(blocks)
    rh, rw = th + 2 * halo, tw + 2 * halo
    rh1, rw1 = (2 * rh + 1, 2 * rw + 1) if blocks[0] == "s2ds" else (rh, rw)
    g = max(1, min(b, REGION_PIXELS // (rh * rw)))
    nwork = -(-b // g) * -(-ho // th) * -(-wo // tw)
    grid = max(1, min(nwork, BLOCKS_PER_SM * sm_count))
    slab = g * (rh * rw * cout + rh1 * rw1 * planes_max + rh * rw * planes_max)
    return {"ho": ho, "wo": wo, "th": th, "tw": tw, "halo": halo, "g": g, "nwork": nwork,
            "grid": grid, "scratch_bytes": slab * grid * itemsize}


def check_cuda_tensor(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: every weight must be contiguous {x.dtype} on {x.device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}")


def fused_chain(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: Sequence[str],
                band: int = 32, act_s=None) -> torch.Tensor:
    """A chain of bottlenecks ``[B, H, W, Cin] -> [B, Ho, Wo, Cout]``. ``band``
    is the TPU kernel's VMEM tiling and does not change the result: the CUDA
    kernel ignores it. ``fused_chain.launches`` counts kernel launches."""
    blocks = tuple(blocks)
    if x.device.type == "cpu":
        return fused_chain_plain(x, folded, blocks, band=band, act_s=act_s)
    if x.device.type != "cuda":
        raise ValueError(f"fused_chain: unsupported device {x.device}")
    _check_blocks(blocks, act_s)
    if x.dim() != 4 or x.dtype not in DTYPE_CODE or not x.is_contiguous():
        raise ValueError(
            f"fused_chain: x must be contiguous [B, H, W, C] float32 or bfloat16, got "
            f"{tuple(x.shape)} {x.dtype}")
    if len(blocks) > MAX_BLOCKS:
        raise ValueError(f"fused_chain: at most {MAX_BLOCKS} blocks a call, got {len(blocks)}")
    if any(k != "id" for k in blocks[1:]):
        raise NotImplementedError(
            "fused_chain: the CUDA kernel takes a projection block only as the first of a "
            f"chain, got {blocks}")
    per_block = split_folded(folded, blocks)
    vec = 16 // x.element_size()
    b, h, w, cin = x.shape
    cout = per_block[0][6].shape[-1]
    ptrs: list[int | None] = []
    cins, planes = [], []
    for kind, t in zip(blocks, per_block):
        for wt in t:
            check_cuda_tensor("fused_chain", wt, x)
        ci, pl = t[0].shape
        ok = (t[3].shape == (3, 3, pl, pl) and t[6].shape == (pl, cout) and ci == cin
              and all(t[i].numel() == n for i, n in ((1, pl), (2, pl), (4, pl), (5, pl),
                                                     (7, cout), (8, cout))))
        if kind != "id":
            ok = ok and t[9].shape == (cin, cout) and t[10].numel() == t[11].numel() == cout
        elif cin != cout:
            ok = False
        if not ok or ci % vec or pl % vec or cout % vec:
            raise ValueError(
                f"fused_chain: block {kind!r} with weights {[tuple(v.shape) for v in t]} does "
                f"not fit input channels {cin}, output channels {cout} (channel counts must "
                f"be multiples of {vec})")
        ptrs += [v.data_ptr() for v in t] + [None] * (12 - len(t))
        cins.append(cin)
        planes.append(pl)
        cin = cout
    props = torch.cuda.get_device_properties(x.device)
    plan = chain_plan(b, h, w, cout, max(planes), blocks, x.element_size(),
                      props.multi_processor_count)
    out = torch.empty((b, plan["ho"], plan["wo"], cout), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=x.device)
    n = len(blocks)
    fn = _build.library("fused_resnet").avcer_fused_chain
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), plan["scratch_bytes"],
                (ctypes.c_void_p * (12 * n))(*ptrs),
                (ctypes.c_int * n)(*[KINDS[k] for k in blocks]),
                (ctypes.c_int * n)(*cins), (ctypes.c_int * n)(*planes), n,
                b, h, w, cout, plan["th"], plan["tw"], plan["g"], plan["grid"],
                DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_chain kernel launch failed: CUDA error {rc}")
    fused_chain.launches += 1
    return out


fused_chain.launches = 0


def fused_layer1(x: torch.Tensor, folded: Sequence[torch.Tensor], band: int = 32) -> torch.Tensor:
    """The whole torchvision-resnet50 layer1: ``[B, H, W, 64] -> [.., 256]``."""
    return fused_chain(x, folded, ("ds", "id", "id"), band=band)
