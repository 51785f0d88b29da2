"""Shared building blocks (avcer_tpu/models/layers.py), only the parts the
ported path uses.

- ``BatchNorm``: inference BatchNorm with torch's state names, computed like
  avcer_tpu's ``TorchBatchNorm``: scale and shift folded in f32, applied in
  the activation's dtype. Each model passes its own eps.
- ``fold_bn`` and ``FoldCache``: a convolution and its inference BatchNorm
  folded to ``(w, inv, shift)`` for the fused kernels, folded once and kept.
- ``LayerNorm``: computed in f32 and cast back to the input's dtype, the
  rounding points of the JAX package's ``nn.LayerNorm(dtype=float32)``.
- ``gelu_exact`` and ``scaled_dot_attention`` (the plain attention of the
  audio heads' ``TransformerLayer``).
- ``cast_compute``: puts a model's conv, linear and embedding weights in the
  compute dtype and keeps the norms' parameters in f32, as the JAX modules
  keep f32 parameters and cast them at use.
- int8 serving: ``int8_conv`` and ``int8_matmul`` (symmetric quantisation,
  one scale per activation tensor and one per output channel of the weight,
  exact int32 sums), the drop-in modules ``QConv``, ``QDense`` and
  ``QConv1d`` with the parameter names of the exact modules they replace, the
  activation scales' three modes (calibrating, calibrated, uncalibrated) and
  the tree of calibrated scales (``act_scales``, ``load_act_scales``,
  ``merge_act_scales_trees``). ``fold_bn_q`` folds a ``QConv`` and its
  BatchNorm for the fused kernels' int8 mode.

The int8 products go through ``torch._int_mm`` (int8 x int8 -> int32 on the
tensor cores through cuBLASLt on the card, exact on the CPU too): a linear
layer directly, a convolution over its input unfolded tap by tap in int8.
``F.conv2d`` takes no integer tensors on the card.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 of [B, C, ...] with the state names of
    ``nn.BatchNorm{1,2}d`` (so torch checkpoints load strictly)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        shift = self.bias.float() - self.running_mean.float() * inv
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


@torch.no_grad()
def fold_bn(conv_weight: torch.Tensor, bn: BatchNorm, dtype: torch.dtype
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(w, inv, shift)`` of a conv followed by an inference BatchNorm, as the
    JAX package's ``TVBottleneckFolded.bn_fold`` and ``_ConvBNFolded`` fold
    them: ``inv = scale * rsqrt(var + eps)`` and ``shift = bias - mean * inv``
    in f32, then cast to ``dtype`` and shaped ``[1, C]``; the weight from
    torch's ``[co, ci, kh, kw]`` to ``[kh, kw, ci, co]``, ``[ci, co]`` for a
    1x1."""
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * inv
    w = conv_weight.permute(2, 3, 1, 0)
    if w.shape[0] == w.shape[1] == 1:
        w = w[0, 0]
    return (w.to(dtype).contiguous(), inv.reshape(1, -1).to(dtype),
            shift.reshape(1, -1).to(dtype))


class FoldCache(nn.Module):
    """Base of a model with fused sections: folded weights are made at the
    first fused forward and kept (folding on every call costs some nine
    small launches per BatchNorm); they are dropped when the parameters move
    (``.to``), a state dict is loaded or the int8 activation scales change.
    While ``calibrating`` is set (``layers.calibrating``) the model runs its
    unfused modules, whatever its fused switches say: only those update the
    scales."""

    calibrating = False

    def __init__(self):
        super().__init__()
        self._folds: dict = {}

    def folded(self, key, make):
        if key not in self._folds:
            self._folds[key] = make()
        return self._folds[key]

    def _apply(self, fn, *args, **kwargs):
        self._folds.clear()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._folds.clear()
        return super()._load_from_state_dict(*args, **kwargs)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32, result cast back to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def scaled_dot_attention(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, H, Tk, D]
    v: torch.Tensor,  # [B, H, Tk, D]
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Unmasked attention as avcer_tpu's plain op: logits accumulated in f32
    (bf16 products are exact in f32), f32 softmax, weights cast to ``dtype``
    before the product with V."""
    d = q.shape[-1]
    sqrt_d = torch.tensor(float(d), dtype=torch.float32).sqrt().to(q.device)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / sqrt_d
    weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.matmul(weights, v.to(dtype))


def cast_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Weights of convolutions and linear layers in ``dtype``; norms (and
    anything else) stay f32. The int8 modules keep their f32 master weights
    (the weight scales are taken over them) and are told the compute dtype."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            m.to(dtype)
        elif isinstance(m, QModule):
            m.dtype = dtype
    return model


def compute_dtype(m: nn.Module) -> torch.dtype:
    """The dtype a conv or linear module computes in."""
    return m.dtype if isinstance(m, QModule) else m.weight.dtype


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------

def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax / 127, 1e-10)`` in f32, a true division: on the card a
    division by a Python number is a multiplication by its reciprocal, one ulp
    off on some inputs, so the divisor is a tensor."""
    amax = amax.float()
    return torch.clamp_min(amax / amax.new_full((), 127.0), 1e-10)


def activation_scale(x: torch.Tensor, act_amax: Optional[torch.Tensor]) -> torch.Tensor:
    """``sx = max(amax / 127, 1e-10)`` in f32: ``amax`` calibrated, or the
    tensor's own max-abs (dynamic, one reduction per call)."""
    return scale_of(x.abs().max() if act_amax is None else act_amax)


def quantize(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / sx), -127, 127)`` as int8: f32, a true division,
    round half to even."""
    return torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``weight`` ``[co, ...]`` (the f32 master weight) -> ``(wq int8 [co,
    ...], sw f32 [co])`` with one scale per output channel."""
    w = weight.float()
    sw = scale_of(w.reshape(w.shape[0], -1).abs().amax(dim=1))
    wq = torch.clamp(torch.round(w / sw.reshape(-1, *([1] * (w.dim() - 1)))), -127, 127)
    return wq.to(torch.int8), sw


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b_t [N, K].T`` for int8 operands, int32 result, exact.
    ``torch._int_mm`` wants M > 16 and K and N multiples of 8 on the card and
    the second operand column-major: zero rows and columns pad up to that."""
    m, k = a.shape
    n = b_t.shape[0]
    pm, pk, pn = max(0, 17 - m), (-k) % 8, (-n) % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pn or pk:
        b_t = F.pad(b_t, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m, :n] if pm or pn else out


def int8_conv(x: torch.Tensor, weight: torch.Tensor, *, stride: tuple[int, int] = (1, 1),
              padding: int = 0, out_dtype: torch.dtype = torch.bfloat16,
              act_amax: Optional[torch.Tensor] = None,
              wq: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """int8 convolution of NCHW ``x`` with ``weight`` ``[co, ci, kh, kw]``
    (avcer_tpu's ``int8_conv``): the activation quantised with one scale (the
    calibrated ``act_amax`` or its own max-abs), the weight with one scale per
    output channel, the products summed exactly in int32, the result ``(sum *
    (sx * sw))`` in f32 rounded to ``out_dtype``. ``padding`` zeros on every
    side (a zero quantises to zero, so padding the input first is the same).
    ``wq``: the weight already quantised (``quantize_weight``). The result is
    NCHW-shaped, channels-last in memory."""
    sx = activation_scale(x, act_amax)
    wq, sw = wq if wq is not None else quantize_weight(weight)
    co, ci, kh, kw = wq.shape
    xq = quantize(x, sx).permute(0, 2, 3, 1)  # NHWC
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    b, h, w, _ = xq.shape
    sh, sw_ = stride
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw_ + 1
    # the input unfolded tap by tap, channels fastest: [M, kh * kw * ci]
    taps = [xq[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw_ * (wo - 1) + 1:sw_]
            for i in range(kh) for j in range(kw)]
    cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
    acc = int_mm(cols.reshape(b * ho * wo, kh * kw * ci),
                 wq.permute(0, 2, 3, 1).reshape(co, kh * kw * ci))
    y = (acc.float() * (sx * sw)).to(out_dtype)
    return y.reshape(b, ho, wo, co).permute(0, 3, 1, 2)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor, *,
                out_dtype: torch.dtype = torch.bfloat16,
                act_amax: Optional[torch.Tensor] = None,
                wq: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """int8 product over the last axis, ``x [..., K]`` with ``weight`` ``[N,
    K]`` (torch's Linear layout); scales and sums as ``int8_conv``."""
    sx = activation_scale(x, act_amax)
    wq, sw = wq if wq is not None else quantize_weight(weight)
    acc = int_mm(quantize(x, sx).reshape(-1, x.shape[-1]), wq)
    return (acc.float() * (sx * sw)).to(out_dtype).reshape(*x.shape[:-1], wq.shape[0])


class QModule(nn.Module):
    """Base of the int8 modules: the f32 master ``weight`` (and ``bias``)
    under the exact module's names, the compute dtype ``dtype``
    (``cast_compute`` sets it), and the activation scale.

    ``amax`` is a buffer outside the state dict (a state dict of the exact
    module loads strictly). Its three modes: while ``calibrating`` (see
    ``layers.calibrating``) the running max takes in each input and is used;
    once ``calibrated`` it is a static scalar; otherwise ``activation_amax``
    is ``None`` and the scale is the input's own max-abs, per call."""

    def __init__(self):
        super().__init__()
        self.register_buffer("amax", torch.zeros((), dtype=torch.float32), persistent=False)
        self.calibrating = False
        self.calibrated = False
        self.dtype = torch.float32
        self._wq: Optional[tuple[torch.Tensor, torch.Tensor]] = None

    def activation_amax(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        if self.calibrating:
            self.amax.copy_(torch.maximum(self.amax, x.detach().abs().max().float()))
            self.calibrated = True
            return self.amax
        return self.amax if self.calibrated else None

    def quantized_weight(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``quantize_weight`` of the master weight, made once and kept until
        the parameters move or a state dict is loaded."""
        if self._wq is None:
            with torch.no_grad():
                self._wq = quantize_weight(self.weight)
        return self._wq

    def _apply(self, fn, *args, **kwargs):
        self._wq = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._wq = None
        return super()._load_from_state_dict(*args, **kwargs)

    def _add_bias(self, y: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(self.dtype).reshape(shape)


class QConv(QModule):
    """int8 stand-in for ``nn.Conv2d`` (``weight`` ``[co, ci, kh, kw]``,
    optional ``bias``) on NCHW input in the compute dtype."""

    def __init__(self, inp: int, oup: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.stride = (stride, stride)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(oup, inp, k, k))
        self.bias = nn.Parameter(torch.zeros(oup)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_conv(x, self.weight, stride=self.stride, padding=self.padding,
                      out_dtype=self.dtype, act_amax=self.activation_amax(x),
                      wq=self.quantized_weight())
        return self._add_bias(y, (1, -1, 1, 1))


class QConv1d(QModule):
    """int8 stand-in for an unpadded ``nn.Conv1d`` (``weight`` ``[co, ci,
    k]``) on ``[B, C, T]`` input: a convolution of height 1."""

    def __init__(self, inp: int, oup: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(oup, inp, k))
        self.bias = nn.Parameter(torch.zeros(oup)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wq, sw = self.quantized_weight()
        y = int8_conv(x[:, :, None, :], self.weight, stride=(1, self.stride),
                      out_dtype=self.dtype, act_amax=self.activation_amax(x),
                      wq=(wq[:, :, None, :], sw))[:, :, 0]
        return self._add_bias(y, (1, -1, 1))


class QDense(QModule):
    """int8 stand-in for ``nn.Linear`` (``weight`` ``[out, in]``)."""

    def __init__(self, inp: int, oup: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(oup, inp))
        self.bias = nn.Parameter(torch.zeros(oup)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.weight, out_dtype=self.dtype,
                        act_amax=self.activation_amax(x), wq=self.quantized_weight())
        return self._add_bias(y, (-1,))


def q_modules(model: nn.Module) -> dict[str, QModule]:
    return {name: m for name, m in model.named_modules() if isinstance(m, QModule)}


def _drop_folds(model: nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, FoldCache):
            m._folds.clear()


@contextlib.contextmanager
def calibrating(model: nn.Module) -> Iterator[None]:
    """Forwards of ``model`` inside this block update every int8 module's
    running max-abs (scales only grow) and run the unfused modules, whatever
    the model's fused switches say. On leaving, the scales are static and the
    folded weights that held the old scales are dropped."""
    flagged = [m for m in model.modules() if isinstance(m, (QModule, FoldCache))]
    for m in flagged:
        m.calibrating = True
    try:
        yield
    finally:
        for m in flagged:
            m.calibrating = False
        _drop_folds(model)


def act_scales(model: nn.Module) -> dict[str, torch.Tensor]:
    """The calibrated scales of ``model``: ``{module path: amax}`` (copies)."""
    return {name: m.amax.detach().clone() for name, m in q_modules(model).items()
            if m.calibrated}


def load_act_scales(model: nn.Module, tree: Mapping[str, torch.Tensor]) -> None:
    """Set every int8 module's scale from ``tree`` (``{module path: amax}``).
    Raises when the tree's paths are not exactly the model's int8 modules."""
    mods = q_modules(model)
    if set(tree) != set(mods):
        odd = sorted(set(tree) ^ set(mods))
        raise ValueError(f"act_scales do not fit the model's int8 modules: {odd[:6]} ...")
    with torch.no_grad():
        for name, m in mods.items():
            m.amax.copy_(torch.as_tensor(tree[name], dtype=torch.float32).reshape(()))
            m.calibrated = True
    _drop_folds(model)


def merge_act_scales_trees(current: Mapping[str, torch.Tensor],
                           incoming: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Elementwise running max of two scale trees (scales only grow). Raises
    on a structure mismatch."""
    if set(current) != set(incoming):
        odd = sorted(set(current) ^ set(incoming))
        raise ValueError(f"act_scales trees differ in structure: {odd[:6]} ...")
    return {k: torch.maximum(torch.as_tensor(current[k], dtype=torch.float32),
                             torch.as_tensor(incoming[k], dtype=torch.float32).to(
                                 torch.as_tensor(current[k]).device))
            for k in current}


@torch.no_grad()
def fold_bn_q(conv: QConv, bn: BatchNorm
              ) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """``((wq, mult, shift), sx)`` of a calibrated ``QConv`` and its inference
    BatchNorm for the fused kernels' int8 mode, as the JAX package's quant
    folds make them: ``wq`` int8 ``[kh, kw, ci, co]`` (``[ci, co]`` for a 1x1),
    ``mult = (sw * sx) * inv`` and ``shift`` f32 ``[1, co]``, and the raw
    activation scale ``sx`` the kernel quantises its input with."""
    if not conv.calibrated:
        raise RuntimeError("the fused int8 path needs calibrated activation scales "
                           "(layers.calibrating or load_act_scales)")
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * inv
    wq, sw = conv.quantized_weight()
    wq = wq.permute(2, 3, 1, 0)
    if wq.shape[0] == wq.shape[1] == 1:
        wq = wq[0, 0]
    sx = scale_of(conv.amax)
    return ((wq.contiguous(), ((sw * sx) * inv).reshape(1, -1).contiguous(),
             shift.reshape(1, -1).contiguous()), sx)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal (2 std) with variance
    1 / fan_in, fan_in over every dim but the first (torch weight layout)."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def seeded_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Deterministic random init with the JAX package's initializers: lecun
    normal kernels, zero biases, unit norms, zero mean and unit variance
    running stats. Used when no checkpoint is given."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        with torch.no_grad():
            if p.dim() >= 2:
                lecun_normal_(p, generator)
            elif leaf.startswith("bias"):
                p.zero_()
            elif leaf == "weight":  # norm scales
                p.fill_(1.0)
            else:
                raise ValueError(f"seeded_init_: no rule for parameter {name}")
    return model
