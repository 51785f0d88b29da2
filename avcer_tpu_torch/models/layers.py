"""Shared building blocks (avcer_tpu/models/layers.py), only the parts the
ported path uses.

- ``BatchNorm``: BatchNorm with torch's state names, computed like
  avcer_tpu's ``TorchBatchNorm``. In eval mode scale and shift are folded in
  f32 and applied in the activation's dtype; in ``training`` the batch's
  mean and biased variance are taken in f32 and the running statistics move
  as ``new = (1 - m) * old + m * batch`` with the unbiased variance (torch's
  ``momentum=m``). Each model passes its own eps and momentum.
- ``Dropout``: the JAX package's ``nn.Dropout`` (keep with probability
  ``1 - p``, kept values divided by ``1 - p``), active only in ``training``,
  its masks drawn from an explicit ``torch.Generator`` that
  ``set_dropout`` hands to every dropout of a model.
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
  BatchNorm for the fused kernels' int8 mode. Differentiated, an int8 module
  is a straight-through estimator (avcer_tpu's ``_ste``): the int8 program's
  forward, the exact op's gradient.
- ``drop_caches``: forgets the folded and quantised weights a model keeps, as
  a training step must after it moves the parameters in place; while
  ``training`` the int8 modules quantise their weight anew at every call and
  ``FoldCache.folded`` refuses (a model in training takes no fused path).

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

from avcer_tpu_torch.utils import trace


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of [B, C, ...] with the state names of
    ``nn.BatchNorm{1,2}d`` (so torch checkpoints load strictly). ``momentum``
    in torch's convention (the weight of the batch's statistics)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        #: (group, replica index) under a data-parallel trainer: the batch
        #: statistics are then the global batch's (``parallel.mesh.ReplicaGroup``)
        self.sync = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            return self._batch_stats(x, shape)
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        shift = self.bias.float() - self.running_mean.float() * inv
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)

    def _batch_stats(self, x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
        """The batch's mean and biased variance in f32 normalise ``x``; the
        running statistics take them in (the variance unbiased)."""
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        n = xf.numel() // xf.shape[1]
        if self.sync is None:
            mean = xf.mean(dim=dims)
            var = xf.var(dim=dims, unbiased=False)
        else:
            # two passes over the replicas' shards, as the one-device path
            # takes the mean and then the centred squares
            group, i = self.sync
            count = torch.full((1,), float(n), device=xf.device)
            sums = group.all_sum(i, torch.cat([xf.sum(dim=dims), count]))
            n = int(round(float(sums[-1].detach())))
            mean = sums[:-1] / n
            var = group.all_sum(i, ((xf - mean.view(shape)) ** 2).sum(dim=dims)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * (var * n / max(n - 1, 1)))
            self.num_batches_tracked += 1
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean.view(shape)) * inv.view(shape) + self.bias.float().view(shape)
                ).to(x.dtype)


class TensorParallel:
    """The devices of one data row's model axis, for the modules that run
    split over it (a ``tp_names`` tuple and a ``tp`` attribute): shard ``m``
    of a weight on device ``m``, and the sum of the row-parallel partial
    products on the first device. Set by ``train.trainer`` where the rules of
    ``parallel.mesh`` split every parameter of the module."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def shard(self, w: Optional[torch.Tensor], dim: int, m: int) -> Optional[torch.Tensor]:
        return None if w is None else w.chunk(self.size, dim)[m].to(self.devices[m])

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(out.device)
        return out


def tp_linear_pair(tp: TensorParallel, x: torch.Tensor, first: nn.Linear, second: nn.Linear,
                   inner) -> torch.Tensor:
    """``second(inner(first(x)))`` with ``first`` column-parallel and
    ``second`` row-parallel over ``tp``: shard m computes ``inner`` on its
    slice of the features; the partial products are summed, then
    ``second``'s bias added."""
    parts = []
    for m, dev in enumerate(tp.devices):
        h = F.linear(x.to(dev), tp.shard(first.weight, 0, m), tp.shard(first.bias, 0, m))
        parts.append(F.linear(inner(h), tp.shard(second.weight, 1, m)))
    out = tp.reduce(parts)
    return out if second.bias is None else out + second.bias


class Dropout(nn.Module):
    """flax's ``nn.Dropout(p)``: in ``training`` each value is kept with
    probability ``1 - p`` and divided by ``1 - p``, else zero; in eval mode,
    or at ``p == 0``, the identity. The masks come from ``generator`` (a
    ``torch.Generator`` on the input's device, see ``set_dropout``), never
    from the global one: a training forward without it raises."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training needs a generator: layers.set_dropout("
                               "model, generator=torch.Generator(device))")
        keep_prob = 1.0 - self.p
        # drawn on the generator's device (a tensor-parallel shard may sit on
        # another device of its row)
        keep = (torch.rand(x.shape, generator=self.generator, device=self.generator.device)
                < keep_prob).to(x.device)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout(model: nn.Module, generator: Optional[torch.Generator] = None,
                p: Optional[float] = None) -> None:
    """Hand ``generator`` to every ``Dropout`` of ``model`` (and, where ``p``
    is given, set every probability to it: ``p=0.0`` turns dropout off)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            if generator is not None:
                m.generator = generator
            if p is not None:
                m.p = p


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
        if self.training:
            raise RuntimeError("folded weights are for inference: a model in training "
                               "takes its unfused modules")
        if key not in self._folds:
            with trace.setup("fold", model=type(self).__name__):
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
    before the product with V. Under ``torch.autocast`` (training) it keeps
    these types: autocast would round the f32 logits' product to bf16."""
    d = q.shape[-1]
    sqrt_d = torch.tensor(float(d), dtype=torch.float32).sqrt().to(q.device)
    with torch.autocast(q.device.type, enabled=False):
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
        the parameters move or a state dict is loaded; in ``training`` made
        anew at every call (an optimizer step moves the weight in place)."""
        if self.training:
            with torch.no_grad():
                return quantize_weight(self.weight)
        if self._wq is None:
            with torch.no_grad():
                self._wq = quantize_weight(self.weight)
        return self._wq

    def straight_through(self, x: torch.Tensor, int8_fn, exact_fn) -> torch.Tensor:
        """``int8_fn(x, weight)``; where autograd records the call, through
        ``_STE``: the same forward, the gradient of ``exact_fn(x, weight)``."""
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad):
            return _STE.apply(x, self.weight, int8_fn, exact_fn)
        return int8_fn(x, self.weight)

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
        amax = self.activation_amax(x)

        def int8_fn(xx, w):
            return int8_conv(xx, w, stride=self.stride, padding=self.padding,
                             out_dtype=self.dtype, act_amax=amax, wq=self.quantized_weight())

        def exact_fn(xx, w):
            return F.conv2d(xx.float(), w.float(), stride=self.stride,
                            padding=self.padding).to(self.dtype)

        return self._add_bias(self.straight_through(x, int8_fn, exact_fn), (1, -1, 1, 1))


class QConv1d(QModule):
    """int8 stand-in for an unpadded ``nn.Conv1d`` (``weight`` ``[co, ci,
    k]``) on ``[B, C, T]`` input: a convolution of height 1."""

    def __init__(self, inp: int, oup: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(oup, inp, k))
        self.bias = nn.Parameter(torch.zeros(oup)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        amax = self.activation_amax(x)

        def int8_fn(xx, w):
            wq, sw = self.quantized_weight()
            return int8_conv(xx[:, :, None, :], w, stride=(1, self.stride), out_dtype=self.dtype,
                             act_amax=amax, wq=(wq[:, :, None, :], sw))[:, :, 0]

        def exact_fn(xx, w):
            return F.conv1d(xx.float(), w.float(), stride=self.stride).to(self.dtype)

        return self._add_bias(self.straight_through(x, int8_fn, exact_fn), (1, -1, 1))


class QDense(QModule):
    """int8 stand-in for ``nn.Linear`` (``weight`` ``[out, in]``)."""

    def __init__(self, inp: int, oup: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(oup, inp))
        self.bias = nn.Parameter(torch.zeros(oup)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        amax = self.activation_amax(x)

        def int8_fn(xx, w):
            return int8_matmul(xx, w, out_dtype=self.dtype, act_amax=amax,
                               wq=self.quantized_weight())

        def exact_fn(xx, w):
            return torch.matmul(xx.float(), w.float().t()).to(self.dtype)

        return self._add_bias(self.straight_through(x, int8_fn, exact_fn), (-1,))


class _STE(torch.autograd.Function):
    """Straight-through estimator (avcer_tpu/models/layers.py ``_ste``): the
    forward is ``int8_fn(x, weight)``, the backward the vector-Jacobian
    product of ``exact_fn(x, weight)`` at the same inputs."""

    @staticmethod
    def forward(ctx, x, weight, int8_fn, exact_fn):
        ctx.save_for_backward(x, weight)
        ctx.exact_fn = exact_fn
        return int8_fn(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xd = x.detach().requires_grad_(wanted[0])
            wd = weight.detach().requires_grad_(wanted[1])
            inputs = [t for t, w in zip((xd, wd), wanted) if w]
            grads = iter(torch.autograd.grad(ctx.exact_fn(xd, wd), inputs, g))
        return (next(grads) if wanted[0] else None, next(grads) if wanted[1] else None,
                None, None)


def drop_caches(model: nn.Module) -> None:
    """Forget every folded weight (``FoldCache``) and quantised weight
    (``QModule``) of ``model``: after an optimizer step they would be stale."""
    for m in model.modules():
        if isinstance(m, FoldCache):
            m._folds.clear()
        elif isinstance(m, QModule):
            m._wq = None


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
