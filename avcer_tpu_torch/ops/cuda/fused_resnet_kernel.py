"""Wrapper of the CUDA bottleneck-chain kernel (``csrc/fused_resnet.cu``), the
counterpart of avcer_tpu/ops/pallas/fused_resnet_kernel.py ``fused_chain`` and
``fused_layer1``.

Public layout as the JAX function's: ``x`` is ``[B, H, W, Cin]`` NHWC;
``folded`` is the flat tuple of ``(w, inv, shift)`` per conv (conv1, conv2,
conv3 and, for a projection block, the projection), ``w`` matmul-shaped
``[ci, co]`` for a 1x1 and ``[3, 3, ci, co]`` for the 3x3, ``inv`` and
``shift`` the folded BatchNorm ``[1, C]``; ``blocks`` is a tuple of ``"ds" |
"id" | "s2ds" | "s2pre"``.

The int8 mode (``act_s``), as the JAX function's: ``folded`` then holds
``(wq int8, mult f32, shift f32)`` per conv, ``mult = sx * sw * bn_inv`` the
merged dequantisation and BatchNorm multiply, and ``act_s`` the static
activation scale ``sx`` of every conv in the order conv1, conv2, conv3, then
the projection, per block. ``x`` and the result stay in the compute dtype;
the sums are exact integers. The kernel's int8 product reads each ``wq``
packed ``[taps, co, ci]`` (``pack_chain_q``): a caller that folds once packs
once and hands the copy in as ``packed``; without it a CUDA call packs its
own.

``fused_chain_flat`` is the counterpart of the JAX package's
``fused_chain_flat``: stride-1 chains over flat bands, its own kernel.

Dispatch rule, with no fallback: a CPU tensor goes to the plain version
(``fused_chain_plain``, ``fused_chain_flat_plain``); a CUDA tensor launches
the kernel (one launch per call) or raises.
"""

from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from avcer_tpu_torch import _build
from avcer_tpu_torch.utils import trace

KINDS = {"id": 0, "ds": 1, "s2ds": 2, "s2pre": 3}
MAX_BLOCKS = 6
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: resident thread blocks per SM the persistent grid is sized for
BLOCKS_PER_SM = 2
#: the most thread blocks a cluster of ``fused_chain`` holds
MAX_CLUSTER = 4
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


def quantize_plain(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / sx), -127, 127)`` in f32: true division, round half to
    even. The values are integers, returned as float64 for an exact product."""
    return torch.clamp(torch.round(x.float() / sx.float()), -127, 127).double()


def conv_bn_plain_q(x: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, mult: torch.Tensor,
                    shift: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The int8 mode's conv on NCHW ``x``: quantise with the static scale
    ``sx``, an exact integer product (float64 holds every sum of int8
    products exactly, on the CPU and on the card), then ``sum * mult + shift``
    in f32 with two roundings, and one rounding to ``x``'s dtype."""
    if wq.dim() == 2:
        weight, pad = wq.t()[:, :, None, None], 0
    else:
        weight, pad = wq.permute(3, 2, 0, 1), 1
    acc = F.conv2d(quantize_plain(x, sx), weight.double(), stride=stride, padding=pad)
    y = acc.float() * mult.float().reshape(1, -1, 1, 1)
    return (y + shift.float().reshape(1, -1, 1, 1)).to(x.dtype)


def pack_chain_q(folded: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """The int8 weights of a chain's folds (flat ``(wq, mult, shift)`` per
    conv) as the kernel's int8 product reads them: one ``[taps, co, ci]`` int8
    tensor per conv (``wq`` ``[ci, co]`` -> ``[1, co, ci]``, ``[3, 3, ci, co]``
    -> ``[9, co, ci]``, tap ``3 ky + kx``), in the order of ``folded``. Input
    channels are contiguous, so the product loads both operands with
    ``ldmatrix`` (sm_90 has no 8-bit transposing ``ldmatrix``). Meant to run
    once per fold: ``pack_chain_q.calls`` counts its calls."""
    if len(folded) % 3:
        raise ValueError(f"pack_chain_q: {len(folded)} tensors are not (wq, mult, shift) triples")
    pack_chain_q.calls += 1
    with trace.setup("pack"):
        return tuple(w.reshape(-1, *w.shape[-2:]).transpose(1, 2).contiguous()
                     for w in folded[0::3])


pack_chain_q.calls = 0


def packed_shape(w: torch.Tensor) -> tuple[int, int, int]:
    """``(taps, co, ci)``: the shape of ``pack_chain_q``'s copy of ``w``."""
    return w.numel() // w.shape[-2:].numel(), w.shape[-1], w.shape[-2]


def _check_blocks(blocks: Sequence[str], act_s, n_folded: int) -> None:
    if not blocks or any(b not in KINDS for b in blocks):
        raise ValueError(f"fused_chain: unknown block kinds in {blocks}")
    if any(b in ("s2ds", "s2pre") for b in blocks[1:]) or (
            blocks[0] in ("s2ds", "s2pre") and any(b != "id" for b in blocks[1:])):
        raise ValueError("a stride-2 entry must be the single entry block")
    if act_s is not None and (act_s.dim() != 1 or 3 * act_s.numel() != n_folded):
        raise ValueError(
            f"fused_chain: act_s must hold one scale per conv ({n_folded // 3}), got "
            f"{tuple(act_s.shape)}")


def fused_chain_plain(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: Sequence[str],
                      band: int = 32, act_s: Optional[torch.Tensor] = None,
                      packed: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The chain in plain PyTorch (``F.conv2d`` on NCHW views, f32
    accumulation or, with ``act_s``, exact integer sums; the kernel's rounding
    points). NHWC in, NHWC out. It reads ``folded`` in the JAX layout;
    ``packed`` (the kernel's copy of the int8 weights) is taken for the
    wrapper's signature and not read."""
    _check_blocks(blocks, act_s, len(folded))
    scales = iter(act_s) if act_s is not None else None

    def conv(h, t, stride=1):
        if scales is None:
            return conv_bn_plain(h, *t, stride=stride)
        return conv_bn_plain_q(h, next(scales), *t, stride=stride)

    h = x.permute(0, 3, 1, 2)
    for kind, t in zip(blocks, split_folded(folded, blocks)):
        s1 = 2 if kind == "s2pre" else 1  # TF v1: the stride on conv1
        s2 = 2 if kind == "s2ds" else 1  # torchvision v1.5: on the 3x3
        y = F.relu(conv(h, t[0:3], s1))
        y = F.relu(conv(y, t[3:6], s2))
        y = conv(y, t[6:9])
        res = h if kind == "id" else conv(h, t[9:12], s1 * s2)
        h = F.relu(y + res)
    return h.permute(0, 2, 3, 1).contiguous()


def tile_edge(dim: int) -> int:
    """Tile edge: a small frame is one tile; a large one is cut evenly into
    tiles of at most 24."""
    return dim if dim <= 32 else -(-dim // -(-dim // 24))


def chain_plan(b: int, h: int, w: int, cout: int, planes_max: int, blocks: Sequence[str],
               itemsize: int, sm_count: int, q_cin: int = 0,
               cluster: Optional[int] = None) -> dict[str, int]:
    """Tiling of one call, as ``csrc/fused_resnet.cu`` derives it again from
    ``th``, ``tw``, ``g``, ``grid`` and ``cluster``: output size, tile, halo,
    frames per work item, the cluster size ``C``, the grid, and the scratch.
    A cluster of C thread blocks works on one work item at a time, so a call
    with fewer work items than the card holds blocks (``BLOCKS_PER_SM *
    sm_count``) spreads each over up to ``MAX_CLUSTER`` blocks: ``C =
    clamp(BLOCKS_PER_SM * sm_count // nwork, 1, MAX_CLUSTER)``, and the grid
    is whole clusters, at most ``BLOCKS_PER_SM * sm_count`` blocks. The
    scratch holds one slab per cluster. ``q_cin``: in the int8 mode the
    input's channels (each slab then also holds an int8 plane of its widest
    conv input), else 0. ``cluster`` overrides C (the card tests force it)."""
    s2 = blocks[0] in ("s2ds", "s2pre")
    ho, wo = ((h + 1) // 2, (w + 1) // 2) if s2 else (h, w)
    th, tw = tile_edge(ho), tile_edge(wo)
    halo = len(blocks) - 1 if blocks[0] == "s2ds" else len(blocks)
    rh, rw = th + 2 * halo, tw + 2 * halo
    rh1, rw1 = (2 * rh + 1, 2 * rw + 1) if blocks[0] == "s2ds" else (rh, rw)
    g = max(1, min(b, REGION_PIXELS // (rh * rw)))
    nwork = -(-b // g) * -(-ho // th) * -(-wo // tw)
    resident = BLOCKS_PER_SM * sm_count
    c = cluster or min(max(resident // nwork, 1), MAX_CLUSTER)
    clusters = max(1, min(nwork, resident // c))
    slab = g * (rh * rw * cout + rh1 * rw1 * planes_max + rh * rw * planes_max)
    qslab = g * rh1 * rw1 * max(q_cin, cout, planes_max) if q_cin else 0
    return {"ho": ho, "wo": wo, "th": th, "tw": tw, "halo": halo, "g": g, "nwork": nwork,
            "cluster": c, "grid": clusters * c,
            "scratch_bytes": (slab * itemsize + qslab) * clusters}


def check_cuda_tensor(name: str, t: torch.Tensor, x: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> None:
    dtype = dtype or x.dtype
    if (t.device != x.device or t.dtype != dtype or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: expected a contiguous, 16-byte aligned {dtype} tensor on {x.device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_chain_weights(name: str, x: torch.Tensor, per_block, blocks, quant: bool,
                         packed: Optional[Sequence[torch.Tensor]] = None
                         ) -> tuple[list, list[int], list[int], int]:
    """Types and shapes of a chain's folded weights against ``x``; returns
    (pointers, input channels per block, planes per block, output channels).
    int8 weights are copied 16 channels at a time. With ``packed``
    (``pack_chain_q`` of the same folds) the pointers of the int8 weights are
    the packed copies'."""
    vec = 16 if quant else 16 // x.element_size()
    cin = x.shape[-1]
    cout = per_block[0][6].shape[-1]
    ptrs: list[int | None] = []
    cins, planes = [], []
    packs = iter(packed) if packed is not None else None
    for kind, t in zip(blocks, per_block):
        for j, wt in enumerate(t):
            want = None if not quant else (torch.int8 if j % 3 == 0 else torch.float32)
            check_cuda_tensor(name, wt, x, want)
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
                f"{name}: block {kind!r} with weights {[tuple(v.shape) for v in t]} does "
                f"not fit input channels {cin}, output channels {cout} (channel counts must "
                f"be multiples of {vec})")
        kernel_t = list(t)
        if packs is not None:
            for j in range(0, len(t), 3):
                p, w = next(packs, None), t[j]
                if p is None or p.shape != packed_shape(w):
                    raise ValueError(f"{name}: the packed weights are not pack_chain_q of the "
                                     f"folds (conv {tuple(w.shape)})")
                check_cuda_tensor(name, p, x, torch.int8)
                kernel_t[j] = p
        ptrs += [v.data_ptr() for v in kernel_t] + [None] * (12 - len(t))
        cins.append(cin)
        planes.append(pl)
        cin = cout
    if packs is not None and next(packs, None) is not None:
        raise ValueError(f"{name}: more packed weights than convs")
    return ptrs, cins, planes, cout


def fused_chain(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: Sequence[str],
                band: int = 32, act_s: Optional[torch.Tensor] = None,
                packed: Optional[Sequence[torch.Tensor]] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A chain of bottlenecks ``[B, H, W, Cin] -> [B, Ho, Wo, Cout]``; with
    ``act_s`` in the int8 mode. ``band`` is the TPU kernel's VMEM tiling and
    does not change the result: the CUDA kernel ignores it. ``packed``:
    ``pack_chain_q(folded)``, made once by a caller that keeps its
    folds (else the int8 mode packs on every CUDA call). ``out``: a tensor
    like the result to write it into (a replay of piecewise graphs hands the
    one its graphs read).
    ``fused_chain.launches`` counts kernel launches; ``fused_chain.occupancy``
    holds what the card reported for each launch configuration (see
    ``chain_occupancy``). While a profiler records, each call is the span
    ``k3`` (``utils.trace``)."""
    blocks = tuple(blocks)
    with trace.span("k3") as sp:
        if sp:
            sp.note(shape=tuple(x.shape), dtype=str(x.dtype), int8=act_s is not None)
        if x.device.type == "cpu":
            res = fused_chain_plain(x, folded, blocks, band=band, act_s=act_s)
            return res if out is None else out.copy_(res)
        if x.device.type != "cuda":
            raise ValueError(f"fused_chain: unsupported device {x.device}")
        return _fused_chain_cuda(x, folded, blocks, act_s, packed=packed, out=out)


def card_occupancy(lib: str, name: str, cache: dict, device: torch.device, dtype: torch.dtype,
                   quant: bool, cluster: int) -> dict[str, int]:
    """What the card reports for kernel ``name`` of library ``lib`` in
    ``dtype`` (int8 mode if ``quant``) launched in clusters of ``cluster``
    blocks (its C entry ``avcer_<name>_occupancy``): the clusters it holds at
    once and the blocks an SM. Asked once per configuration and kept in
    ``cache``; raises where not one cluster fits."""
    key = (str(device), DTYPE_CODE[dtype], int(quant), cluster)
    occ = cache.get(key)
    if occ is None:
        fn = getattr(_build.library(lib), f"avcer_{name}_occupancy")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        clusters, blocks = ctypes.c_int(0), ctypes.c_int(0)
        with trace.setup("occupancy", kernel=name, cluster=cluster), torch.cuda.device(device):
            rc = fn(DTYPE_CODE[dtype], int(quant), cluster, ctypes.byref(clusters),
                    ctypes.byref(blocks))
        if rc != 0 or clusters.value < 1:
            raise RuntimeError(
                f"{name}: the card holds {clusters.value} clusters of {cluster} blocks "
                f"(CUDA error {rc})")
        occ = {"clusters": clusters.value, "blocks_per_sm": blocks.value}
        cache[key] = occ
    return occ


def chain_occupancy(device: torch.device, dtype: torch.dtype, quant: bool,
                    cluster: int) -> dict[str, int]:
    """``card_occupancy`` of the chain kernel, kept in ``fused_chain.occupancy``;
    asked before a configuration's first launch."""
    return card_occupancy("fused_resnet", "fused_chain", fused_chain.occupancy, device, dtype,
                          quant, cluster)


def _fused_chain_cuda(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: tuple,
                      act_s: Optional[torch.Tensor], cluster: Optional[int] = None,
                      packed: Optional[Sequence[torch.Tensor]] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The launch behind ``fused_chain`` for a CUDA tensor; ``cluster``
    forces the cluster size instead of the plan's (the card tests compare
    sizes with it). A cluster the card refuses raises: nothing retries with
    another size. The int8 mode launches on ``packed`` (``pack_chain_q`` of
    ``folded``, packed here when not given). ``out``: the result's tensor,
    made here when not given."""
    _check_blocks(blocks, act_s, len(folded))
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
    quant = act_s is not None
    if quant and packed is None:
        packed = pack_chain_q(folded)
    ptrs, cins, planes, cout = _check_chain_weights(
        "fused_chain", x, split_folded(folded, blocks), blocks, quant,
        packed if quant else None)
    if quant:
        act_s = act_s.to(device=x.device, dtype=torch.float32).contiguous()
    b, h, w, _ = x.shape
    props = torch.cuda.get_device_properties(x.device)
    plan = chain_plan(b, h, w, cout, max(planes), blocks, x.element_size(),
                      props.multi_processor_count, q_cin=cins[0] if quant else 0,
                      cluster=cluster)
    shape = (b, plan["ho"], plan["wo"], cout)
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif (tuple(out.shape) != shape or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError(f"fused_chain: out must be contiguous {shape} {x.dtype} on {x.device}")
    if b == 0:
        return out
    chain_occupancy(x.device, x.dtype, quant, plan["cluster"])
    trace.annotate("k3", C=plan["cluster"], grid=plan["grid"])
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=x.device)
    n = len(blocks)
    lib = _build.library("fused_resnet")
    fn = lib.avcer_fused_chain_q if quant else lib.avcer_fused_chain
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p] * (2 if quant else 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), plan["scratch_bytes"],
                (ctypes.c_void_p * (12 * n))(*ptrs),
                (ctypes.c_int * n)(*[KINDS[k] for k in blocks]),
                (ctypes.c_int * n)(*cins), (ctypes.c_int * n)(*planes), n,
                b, h, w, cout, plan["th"], plan["tw"], plan["g"], plan["grid"], plan["cluster"],
                DTYPE_CODE[x.dtype], *((act_s.data_ptr(),) if quant else ()), stream)
    if rc != 0:
        raise RuntimeError(f"fused_chain kernel launch failed: CUDA error {rc}")
    trace.launched(fused_chain)
    return out


fused_chain.launches = 0
fused_chain.occupancy = {}


def fused_layer1(x: torch.Tensor, folded: Sequence[torch.Tensor], band: int = 32) -> torch.Tensor:
    """The whole torchvision-resnet50 layer1: ``[B, H, W, 64] -> [.., 256]``."""
    return fused_chain(x, folded, ("ds", "id", "id"), band=band)


#: pixels of one tile of the kernels' products (conv_tile.cuh kBM)
TILE_ROWS = 128


def band_heights(h: int, band: int) -> list[int]:
    """The band heights that cut ``h`` rows into bands of equal height but the
    last, at most ``band`` rows each, tallest first."""
    return sorted({-(-h // nb) for nb in range(-(-h // band), h + 1)}, reverse=True)


def flat_plan(b: int, h: int, w: int, n: int, cout: int, planes_max: int, itemsize: int,
              held: Mapping[int, int], band: int = 32, cluster: Optional[int] = None,
              th: Optional[int] = None) -> dict[str, int]:
    """Geometry and launch of one ``fused_chain_flat`` call, as
    ``csrc/fused_resnet.cu`` derives it again from ``th``, ``grid`` and
    ``cluster``: bands of ``th`` output rows and ``n`` halo rows above and
    below, of pitch ``w + 2n`` (the frame's width and n halo columns a side:
    a row is one pixel of contiguous channels, aligned at any pitch, so the
    TPU kernel's rounding to its 8 sublanes is gone); a band is a work item of
    a cluster of ``C`` thread blocks.

    ``th`` (a height of ``band_heights``) and ``C`` (1 to ``MAX_CLUSTER``)
    are chosen together by K4's rule (``fused_ssh_kernel.ssh_plan``) with the
    band's size in it: ``held[C]`` clusters of C blocks fit on the card at
    once, so ``nwork`` bands take ``ceil(nwork / held[C])`` rounds, and each
    block of a cluster computes ``1 / C`` of a band's ``ceil((th + 2n) *
    pitch / TILE_ROWS)`` pixel tiles; the plan takes the fewest rounds x
    tiles a block, ties to the smaller C and then the taller band (fewer
    halo rows). Taller bands recompute fewer halo rows but leave fewer
    bands, which clusters then spread over more SMs. ``cluster`` and ``th``
    force C and the band height (the card tests and the sweep). The scratch
    holds one slab per cluster."""
    pitch = w + 2 * n
    best = None
    for t in ([th] if th else band_heights(h, band)):
        nwork = b * -(-h // t)
        for c in ([cluster] if cluster else range(1, MAX_CLUSTER + 1)):
            clusters = min(nwork, held[c])
            cost = Fraction(-(-nwork // held[c]) * -(-(t + 2 * n) * pitch // TILE_ROWS), c)
            if best is None or (cost, c, -t) < best[0]:
                best = ((cost, c, -t), t, c, nwork, clusters)
    _, t, c, nwork, clusters = best
    rows = t + 2 * n
    slab = rows * pitch * (cout + 2 * planes_max)
    return {"th": t, "nb": -(-h // t), "pitch": pitch, "rows": rows, "nwork": nwork,
            "cluster": c, "grid": clusters * c, "scratch_bytes": slab * itemsize * clusters}


def _pad_channels(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: Sequence[str],
                  align: int) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """A stride-1 chain's input and weights with the input's channels
    zero-padded to a multiple of ``align`` (and the rows of conv1's and the
    projection's weights that read them): only behind a projection entry."""
    if not blocks or any(b not in ("ds", "id") for b in blocks):
        raise ValueError("fused_chain_flat handles stride-1 chains only")
    folded = list(folded)
    split_folded(folded, blocks)  # the count of tensors fits the blocks
    pad_ch = (-x.shape[-1]) % align
    if pad_ch:
        if blocks[0] == "id":
            raise ValueError(
                f"fused_chain_flat with cin % {align} != 0 needs a projection entry block "
                "(identity residuals cannot be channel-padded)")
        x = F.pad(x, (0, pad_ch))
        folded[0] = F.pad(folded[0], (0, 0, 0, pad_ch))
        folded[9] = F.pad(folded[9], (0, 0, 0, pad_ch))
    return x, folded


def _flat_inputs(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: Sequence[str],
                 band: int, align: int, th: Optional[int] = None):
    """The plain version's flat bands: the input padded by n rows and columns
    and flattened to ``[B, (hp + 2n) * pitch, cin]`` (``hp = nb * th``), the
    per-band frame mask ``[nb, rows * pitch]`` f32, the weights (input
    channels padded as ``_pad_channels`` does), and the geometry: ``th``
    (default the tallest of ``band_heights``), ``nb``, ``hp``, ``pitch = w +
    2n`` and ``rows = th + 2n``."""
    blocks = tuple(blocks)
    x, folded = _pad_channels(x, folded, blocks, align)
    bsz, h, w, cin = x.shape
    n = len(blocks)
    th = th or band_heights(h, band)[0]
    nb = -(-h // th)
    hp, pitch, rows = nb * th, w + 2 * n, th + 2 * n
    xp = F.pad(x, (0, 0, n, n, n, n + hp - h))
    xp = xp.reshape(bsz, (hp + 2 * n) * pitch, cin)
    ri = torch.arange(hp + 2 * n, device=x.device)[:, None]
    ci = torch.arange(pitch, device=x.device)[None, :]
    ok2d = (ri >= n) & (ri < n + h) & (ci >= n) & (ci < n + w)
    mask = torch.stack([ok2d[rb * th: rb * th + rows] for rb in range(nb)])
    geometry = {"th": th, "nb": nb, "hp": hp, "pitch": pitch, "rows": rows}
    return xp, mask.float().reshape(nb, rows * pitch), folded, geometry


def fused_chain_flat_plain(x: torch.Tensor, folded: Sequence[torch.Tensor],
                           blocks: Sequence[str], band: int = 32,
                           th: Optional[int] = None) -> torch.Tensor:
    """``fused_chain_flat`` in plain PyTorch over flat bands of ``th`` rows
    (as ``_flat_inputs`` makes them): each band is read as an image of ``rows
    x pitch`` pixels, its convs are SAME over that image (they differ from the
    flat row-offset taps only in the first and last column, which are halo),
    conv1's output is multiplied by the frame mask, and the central rows'
    frame pixels are the output. The band height changes where a pixel is
    computed, not what."""
    blocks = tuple(blocks)
    bsz, h, w, _ = x.shape
    n = len(blocks)
    xp, mask, folded, plan = _flat_inputs(x, folded, blocks, band, 1, th)
    th, rows, pitch = plan["th"], plan["rows"], plan["pitch"]
    per_block = split_folded(folded, blocks)
    cout = per_block[0][6].shape[-1]
    out = x.new_empty((bsz, plan["hp"], w, cout))
    for rb in range(plan["nb"]):
        cur = xp[:, rb * th * pitch:(rb * th + rows) * pitch]
        cur = cur.reshape(bsz, rows, pitch, -1).permute(0, 3, 1, 2)
        okd = mask[rb].reshape(1, 1, rows, pitch).to(x.dtype)
        for kind, t in zip(blocks, per_block):
            t1 = F.relu(conv_bn_plain(cur, *t[0:3])) * okd
            t2 = F.relu(conv_bn_plain(t1, *t[3:6]))
            y = conv_bn_plain(t2, *t[6:9])
            res = cur if kind == "id" else conv_bn_plain(cur, *t[9:12])
            cur = F.relu(y + res)
        out[:, rb * th:(rb + 1) * th] = cur[:, :, n:n + th, n:n + w].permute(0, 2, 3, 1)
    return out[:, :h].contiguous()


def fused_chain_flat(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: Sequence[str],
                     band: int = 32) -> torch.Tensor:
    """A stride-1 chain (``"ds"`` and ``"id"`` blocks) ``[B, H, W, Cin] -> [B,
    H, W, Cout]`` through the flat kernel, which works on flat bands of at
    most ``band`` output rows (the plan's height), reading ``x`` and writing
    the result in NHWC itself. Same result as ``fused_chain``.
    ``fused_chain_flat.launches`` counts kernel launches;
    ``fused_chain_flat.occupancy`` holds what the card reported for each
    launch configuration (see ``flat_card_plan``)."""
    blocks = tuple(blocks)
    if x.device.type == "cpu":
        return fused_chain_flat_plain(x, folded, blocks, band=band)
    if x.device.type != "cuda":
        raise ValueError(f"fused_chain_flat: unsupported device {x.device}")
    return _fused_chain_flat_cuda(x, folded, blocks, band)


def flat_card_plan(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: Sequence[str],
                   band: int = 32, cluster: Optional[int] = None,
                   th: Optional[int] = None) -> dict[str, int]:
    """``flat_plan`` for a call on ``x``'s card, with what the card holds of
    each cluster size (asked once per configuration, kept in
    ``fused_chain_flat.occupancy``), and the clusters it holds of the chosen
    one (``max_active_clusters``)."""
    per_block = split_folded(folded, blocks)
    b, h, w, _ = x.shape
    sizes = (cluster,) if cluster else range(1, MAX_CLUSTER + 1)
    held = {c: card_occupancy("fused_resnet", "fused_chain_flat", fused_chain_flat.occupancy,
                              x.device, x.dtype, False, c)["clusters"] for c in sizes}
    plan = flat_plan(b, h, w, len(blocks), per_block[0][6].shape[-1],
                     max(t[0].shape[1] for t in per_block), x.element_size(), held, band,
                     cluster, th)
    plan["max_active_clusters"] = held[plan["cluster"]]
    return plan


def _fused_chain_flat_cuda(x: torch.Tensor, folded: Sequence[torch.Tensor], blocks: tuple,
                           band: int = 32, cluster: Optional[int] = None,
                           th: Optional[int] = None) -> torch.Tensor:
    """The launch behind ``fused_chain_flat`` for a CUDA tensor; ``cluster``
    and ``th`` force the cluster size and the band height instead of the
    plan's (the card tests and the sweep). A cluster the card refuses raises:
    nothing retries with another size."""
    if x.dim() != 4 or x.dtype not in DTYPE_CODE or not x.is_contiguous():
        raise ValueError(
            f"fused_chain_flat: x must be contiguous [B, H, W, C] float32 or bfloat16, got "
            f"{tuple(x.shape)} {x.dtype}")
    if len(blocks) > MAX_BLOCKS:
        raise ValueError(f"fused_chain_flat: at most {MAX_BLOCKS} blocks a call, got {len(blocks)}")
    if "ds" in blocks[1:]:
        raise NotImplementedError(
            "fused_chain_flat: the CUDA kernel takes a projection block only as the first of "
            f"a chain, got {blocks}")
    x, folded = _pad_channels(x, folded, blocks, 16 // x.element_size())
    folded = [t.contiguous() for t in folded]
    ptrs, cins, planes, cout = _check_chain_weights(
        "fused_chain_flat", x, split_folded(folded, blocks), blocks, False)
    bsz, h, w, cin = x.shape
    n = len(blocks)
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    if bsz == 0:
        return out
    plan = flat_card_plan(x, folded, blocks, band, cluster, th)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=x.device)
    fn = _build.library("fused_resnet").avcer_fused_chain_flat
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), plan["scratch_bytes"],
                (ctypes.c_void_p * (12 * n))(*ptrs),
                (ctypes.c_int * n)(*[KINDS[k] for k in blocks]),
                (ctypes.c_int * n)(*cins), (ctypes.c_int * n)(*planes), n,
                bsz, h, w, cin, cout, plan["th"], plan["grid"], plan["cluster"],
                DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_chain_flat kernel launch failed: CUDA error {rc}")
    trace.launched(fused_chain_flat)
    return out


fused_chain_flat.launches = 0
fused_chain_flat.occupancy = {}
