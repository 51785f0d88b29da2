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
"""

from __future__ import annotations

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
    (``.to``) or a state dict is loaded."""

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
    anything else) stay f32."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            m.to(dtype)
    return model


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
