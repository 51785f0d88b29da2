"""Wav2Vec2 encoder, large-robust family (avcer_tpu/models/wav2vec2.py).

- conv feature extractor, layer-norm variant: 7 convs, LayerNorm over
  channels in f32, exact GELU;
- feature projection: LayerNorm -> Linear;
- grouped positional conv (kernel 128, 16 groups, weight norm fused into the
  weight), the trailing frame trimmed for an even kernel, GELU;
- stable-layer-norm (pre-LN) encoder layers, then a final LayerNorm. No
  attention mask, as the reference passes none. Each layer's self-attention
  takes its route from ``attention_route``: the CUDA kernel
  (``ops.cuda.attention_kernel.mha``, K2) where no gradient has to pass
  through it (eval, serving, frozen layers in training), the autograd
  attention ``layers.scaled_dot_attention`` where one does (a layer whose
  parameters or input require grad). The kernel has no backward, as the
  Pallas kernel has none.

Training mode (``module.training``): dropout 0.1 where the JAX package has
it (after the feature projection, after the positional embedding is added,
after the attention's output projection, after the FFN's GELU and after its
output), in frozen layers too; ``Wav2Vec2Config.remat`` recomputes each
trainable encoder layer in the backward pass (``torch.utils.checkpoint``,
non-reentrant), its dropout masks drawn again from the same generator state.

LayerNorms run in f32 and cast back at the JAX package's rounding points.
Parameter names are HF ``Wav2Vec2Model``'s, except that the positional conv
holds the fused ``conv.weight`` (HF keeps its weight-norm factors).
Public layout: waveform [B, T] -> hidden states [B, F, hidden].

``Wav2Vec2Config.quant`` is the JAX package's int8 variant over the same
state dict: the feature extractor's convs past the first (the 1-channel first
layer stays exact) are ``layers.QConv1d``, and q, k, v, out and both
feed-forward projections of every encoder layer are ``layers.QDense``;
LayerNorms, the attention kernel, the feature projection and the positional
conv stay exact. ``mode`` splits the forward for the shared extractor:
``"features_only"`` stops after the conv features, ``"from_features"`` starts
from them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.utils.checkpoint

from avcer_tpu_torch.models.layers import (Dropout, LayerNorm, QConv1d, QDense, gelu_exact,
                                           scaled_dot_attention)
from avcer_tpu_torch.ops.cuda.attention_kernel import mha

DROPOUT = 0.1


@dataclass(frozen=True)
class Wav2Vec2Config:
    """Same fields and defaults as avcer_tpu's Wav2Vec2Config, less the
    Pallas attention switch (``attention_route`` decides)."""

    hidden_size: int = 1024
    num_layers: int = 12
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple[int, ...] = (512,) * 7
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    #: recompute the trainable encoder layers in the backward pass
    #: (training only): activation memory for batches of 24 4 s windows
    remat: bool = False
    #: int8 serving (see the module docstring); calibrated through AudioStage
    quant: bool = False

    def num_output_frames(self, num_samples: int) -> int:
        n = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


class ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, bias: bool, eps: float,
                 quant: bool = False):
        super().__init__()
        self.conv = (QConv1d(cin, cout, k, stride=s, bias=bias) if quant
                     else nn.Conv1d(cin, cout, k, stride=s, bias=bias))
        self.layer_norm = LayerNorm(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        h = self.layer_norm(self.conv(x).transpose(1, 2))
        return gelu_exact(h).transpose(1, 2)


class FeatureEncoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(c.conv_dim)
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], k, s, c.conv_bias, c.layer_norm_eps,
                      quant=c.quant and i > 0)
            for i, (k, s) in enumerate(zip(c.conv_kernel, c.conv_stride)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # [B, T] -> [B, F, C]
        h = wav[:, None, :].to(self.conv_layers[0].conv.weight.dtype)
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = LayerNorm(c.conv_dim[-1], eps=c.layer_norm_eps)
        self.projection = nn.Linear(c.conv_dim[-1], c.hidden_size)
        self.dropout = Dropout(DROPOUT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.projection(self.layer_norm(x)))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        k = c.num_conv_pos_embeddings
        self.conv = nn.Conv1d(c.hidden_size, c.hidden_size, k, padding=k // 2,
                              groups=c.num_conv_pos_embedding_groups)
        self.trim = 1 if k % 2 == 0 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        h = self.conv(x.transpose(1, 2))
        if self.trim:
            h = h[:, :, :-self.trim]
        return gelu_exact(h).transpose(1, 2)


def dense(c: Wav2Vec2Config, inp: int, oup: int) -> nn.Module:
    return QDense(inp, oup) if c.quant else nn.Linear(inp, oup)


def attention_route(layer: nn.Module, x: torch.Tensor) -> str:
    """Where the self-attention of ``layer`` on input ``x`` runs: "kernel"
    (K2, which carries no gradient) unless autograd records the call and
    ``x`` or a parameter of ``layer`` requires grad, then "autograd"
    (``layers.scaled_dot_attention``, the JAX training path's XLA attention).
    No fallback: on the card a "kernel" call launches K2 or raises."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in layer.parameters())):
        return "autograd"
    return "kernel"


class Attention(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.num_heads = c.num_heads
        self.q_proj = dense(c, c.hidden_size, c.hidden_size)
        self.k_proj = dense(c, c.hidden_size, c.hidden_size)
        self.v_proj = dense(c, c.hidden_size, c.hidden_size)
        self.out_proj = dense(c, c.hidden_size, c.hidden_size)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, d = h.shape

        def heads(x: torch.Tensor) -> torch.Tensor:  # -> [B, H, T, D]
            return x.reshape(b, t, self.num_heads, d // self.num_heads).transpose(1, 2).contiguous()

        q, k, v = heads(self.q_proj(h)), heads(self.k_proj(h)), heads(self.v_proj(h))
        if attention_route(self, h) == "kernel":
            attn = mha(q, k, v)
        else:
            attn = scaled_dot_attention(q, k, v, dtype=q.dtype)
        return self.out_proj(attn.transpose(1, 2).reshape(b, t, d))


class FeedForward(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = dense(c, c.hidden_size, c.intermediate_size)
        self.output_dense = dense(c, c.intermediate_size, c.hidden_size)
        self.intermediate_dropout = Dropout(DROPOUT)
        self.output_dropout = Dropout(DROPOUT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.intermediate_dropout(gelu_exact(self.intermediate_dense(x)))
        return self.output_dropout(self.output_dense(h))


class EncoderLayerStableLN(nn.Module):
    """Pre-LN transformer layer (HF Wav2Vec2EncoderLayerStableLayerNorm)."""

    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attention = Attention(c)
        self.dropout = Dropout(DROPOUT)
        self.final_layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = FeedForward(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dropout(self.attention(self.layer_norm(x)))
        return x + self.feed_forward(self.final_layer_norm(x))


def checkpointed(layer: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """``layer(h)`` with its activations recomputed in the backward pass. The
    recompute draws its dropout masks from the generators' states of the
    first call (``torch.utils.checkpoint`` restores only the global
    generators), and leaves the generators where they were."""
    gens = list({id(m.generator): m.generator for m in layer.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    first = [g.get_state() for g in gens]
    calls = []

    def run(x: torch.Tensor) -> torch.Tensor:
        calls.append(None)
        if len(calls) == 1:
            return layer(x)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, first):
            g.set_state(state)
        try:
            return layer(x)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return torch.utils.checkpoint.checkpoint(run, h, use_reentrant=False)


class Encoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(c)
        self.layers = nn.ModuleList(EncoderLayerStableLN(c) for _ in range(c.num_layers))
        self.layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = Dropout(DROPOUT)
        self.remat = c.remat

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.dropout(h + self.pos_conv_embed(h))
        for layer in self.layers:
            if self.remat and self.training and attention_route(layer, h) == "autograd":
                h = checkpointed(layer, h)
            else:
                h = layer(h)
        return self.layer_norm(h)


class Wav2Vec2Model(nn.Module):
    """Normalised waveform [B, T] -> hidden states [B, F, hidden].

    ``mode``: ``"full"``; ``"features_only"`` returns the conv features [B, F,
    conv_dim]; ``"from_features"`` takes such features as its input and runs
    the projection and the encoder. Same parameters in every mode."""

    def __init__(self, config: Wav2Vec2Config | None = None):
        super().__init__()
        self.config = config or Wav2Vec2Config()
        self.feature_extractor = FeatureEncoder(self.config)
        self.feature_projection = FeatureProjection(self.config)
        self.encoder = Encoder(self.config)

    def forward(self, wav: torch.Tensor, mode: str = "full") -> torch.Tensor:
        if mode not in ("full", "features_only", "from_features"):
            raise ValueError(f"unknown wav2vec2 mode {mode!r}")
        feats = wav if mode == "from_features" else self.feature_extractor(wav)
        if mode == "features_only":
            return feats
        return self.encoder(self.feature_projection(feats))
