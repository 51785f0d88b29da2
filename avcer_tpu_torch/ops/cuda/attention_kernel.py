"""Wrapper of the CUDA self-attention kernels (``csrc/attention.cu``), the
counterpart of avcer_tpu/ops/pallas/attention_kernel.py ``pallas_mha``.

Dispatch rule, with no fallback: a CPU tensor goes to the plain version in
this module (``mha_plain``); a CUDA tensor launches a kernel or raises. Which
of the two kernels runs depends on the dtype and the shape only
(``kernel_for``): bf16 with D a multiple of 16 and T <= 256 goes to the
tensor-core kernel ``tc``, everything else (f32, longer sequences, other head
dims) to the f32-exact CUDA-core kernel ``exact``.

Bias mode (WavLM's gated relative position bias, ``models.wavlm``): ``bias =
(table [H, nb] f32, buckets [2T - 1] int32, gate [B H, T] f32)`` adds
``gate[b h, i] * table[h, buckets[j - i + T - 1]]`` to the f32 logits after
the division by sqrt(d). On the card only the tensor-core kernel takes it
(``mha_tc_bias_kernel``, the bias built in shared memory, never as a [B, H,
T, T] tensor); a bias where the exact kernel would run is refused.

Tracing (``utils.trace``): each call is the span ``k2`` (``bh``, ``t``, ``d``,
``dtype``, ``bias``, and ``heads`` and ``nb`` for the bias's table) and
counts ``k2.calls``, and with a bias ``k2.bias_calls``.

Gradient rule. The kernels have no backward, as the Pallas kernel has none:
``mha`` writes its result into a fresh tensor outside autograd. So on the
card it refuses (``RuntimeError``) an operand that requires grad while grad
mode is on, rather than return a result that would drop the gradient. The
wav2vec2 encoder chooses per layer (``models.wav2vec2.attention_route``):
this kernel where no gradient has to pass (eval, serving under
``inference_mode``, frozen layers in training), the autograd attention
``models.layers.scaled_dot_attention`` in a layer that trains, as the JAX
package trains through XLA's attention (``use_pallas_attention`` is False
there by default).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from avcer_tpu_torch import _build
from avcer_tpu_torch.utils import trace

MAX_T = 1024
MAX_D = 128
TC_MAX_T = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


Bias = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def relative_bias(bias: Bias, b: int, h: int, t: int) -> torch.Tensor:
    """The bias mode's [B, H, T, T] f32 term: ``gate[b h, i] *
    table[h, buckets[j - i + T - 1]]`` (the plain version's; the kernel never
    forms it)."""
    table, buckets, gate = bias
    pos = torch.arange(t, device=table.device)
    rel = table.float()[:, buckets.long()][:, pos[None, :] - pos[:, None] + t - 1]
    return gate.float().reshape(b, h, t, 1) * rel[None]


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[Bias] = None) -> torch.Tensor:
    """The TPU kernel's math in plain PyTorch: Q, K, V upcast to f32, logits
    divided by sqrt(d) in f32 (then, with ``bias``, ``relative_bias`` added),
    f32 softmax (max, exp, sum, divide), P V in f32, output in q's dtype.
    [B, H, T, D] -> [B, H, T, D]."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sqrt_d = torch.tensor(float(q.shape[-1]), dtype=torch.float32).sqrt()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) / sqrt_d.to(q.device)
    if bias is not None:
        logits = logits + relative_bias(bias, *q.shape[:3])
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vf).to(q.dtype)


_ENTRIES: dict = {}


def _entry(kernel: str):
    """The C entry point of ``kernel`` ("tc", "tc_bias" or "exact"), typed
    once."""
    fn = _ENTRIES.get(kernel)
    if fn is None:
        fn = getattr(_build.library("attention"), f"avcer_mha_{kernel}")
        extra = {"tc": [], "exact": [ctypes.c_int],  # the dtype code
                 "tc_bias": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2}[kernel]
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + extra + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRIES[kernel] = fn
    return fn


def kernel_for(dtype: torch.dtype, t: int, d: int) -> str:
    """The kernel that takes [B, H, t, d] operands of ``dtype``: "tc" (bf16 on
    the tensor cores) or "exact" (f32 on the CUDA cores)."""
    return "tc" if dtype == torch.bfloat16 and t <= TC_MAX_T and d % 16 == 0 else "exact"


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[Bias] = None) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d) [+ the relative position ``bias``]) V over
    [B, H, T, D] operands (f32 or bf16, T <= 1024, D <= 128; with a bias on
    the card bf16, T <= 256, D a multiple of 16). ``mha.launches`` counts
    kernel launches, ``mha.launches_by_kernel`` the same launches by kernel
    (a biased launch under "tc"). While a profiler records, each call is the
    span ``k2`` (``utils.trace``)."""
    with trace.span("k2") as sp:
        if sp:
            attrs = dict(dtype=str(q.dtype), bias=bias is not None)
            if q.dim() == 4:
                attrs.update(bh=q.shape[0] * q.shape[1], t=q.shape[2], d=q.shape[3],
                             heads=q.shape[1], nb=0 if bias is None else bias[0].shape[-1])
            sp.note(**attrs)
        trace.count("k2.calls")
        if bias is not None:
            trace.count("k2.bias_calls")
        return _mha(q, k, v, bias)


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[Bias]) -> torch.Tensor:
    if q.device.type == "cpu":
        return mha_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"mha: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "mha: an operand requires grad, and the kernel has no backward: its result "
            "would carry no gradient. Run the autograd attention there "
            "(models.wav2vec2.attention_route), or call mha under torch.no_grad()")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"mha: {name} is {tuple(x.shape)} {x.dtype} on {x.device}, "
                f"q is {tuple(q.shape)} {q.dtype} on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"mha: operands must be [B, H, T, D], got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"mha: dtype {q.dtype} not supported (f32 or bf16)")
    b, h, t, d = q.shape
    if t > MAX_T or d > MAX_D:
        raise ValueError(f"mha: T = {t}, D = {d} outside T <= {MAX_T}, D <= {MAX_D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha: q, k and v must be contiguous")
    kernel = kernel_for(q.dtype, t, d)
    if kernel == "tc" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("mha: bf16 operands must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if bias is None:
        fn, extra = _entry(kernel), (() if kernel == "tc" else (_DTYPE_CODE[q.dtype],))
    else:
        if kernel != "tc":
            raise ValueError(
                f"mha: a bias runs on the tensor-core kernel only (bf16, T <= {TC_MAX_T}, D a "
                f"multiple of 16); got {q.dtype}, T = {t}, D = {d}")
        table, buckets, gate = bias
        # (tensor, dtype, its shape holds, the shape wanted)
        want = {"table": (table, torch.float32, table.dim() == 2 and table.shape[0] == h,
                          f"[{h}, nb]"),
                "buckets": (buckets, torch.int32, tuple(buckets.shape) == (2 * t - 1,),
                            f"[{2 * t - 1}]"),
                "gate": (gate, torch.float32, gate.numel() == b * h * t, f"[{b * h}, {t}]")}
        for name, (x, dtype, fits, shape) in want.items():
            if not fits or x.dtype != dtype or x.device != q.device or not x.is_contiguous():
                raise ValueError(f"mha: bias {name} must be {shape} {dtype} contiguous on "
                                 f"{q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
        fn, extra = _entry("tc_bias"), (table.data_ptr(), buckets.data_ptr(), gate.data_ptr(),
                                        h, table.shape[-1])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t, d, *extra)
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel {kernel} launch failed: CUDA error {rc}")
    # the data-parallel trainer's replicas launch from their own threads:
    # the count takes a lock
    trace.launched(mha, launches_by_kernel=kernel)
    return out


mha.launches = 0
mha.launches_by_kernel = {"tc": 0, "exact": 0}
