"""WavLM encoder, large family (Chen et al. 2022, "WavLM: Large-Scale
Self-Supervised Pre-Training for Full Stack Speech Processing";
``microsoft/wavlm-large``), as Hugging Face's ``WavLMModel`` computes it with
``do_stable_layer_norm``.

wav2vec2's pieces (``models.wav2vec2``), reused as they are: the layer-norm
conv feature extractor, the feature projection, the grouped positional conv
(weight norm fused) and the pre-LN layer's feed-forward. What WavLM adds is a
gated relative position bias in every layer's self-attention:

- layer 0 alone holds ``rel_attn_embed`` ([num_buckets, heads]); relative
  position ``r = j - i`` falls in ``bucket(r)``: half the buckets for r > 0,
  ``|r| < num_buckets / 4`` exact, beyond that logarithmic up to
  ``max_bucket_distance`` (``relative_buckets``, the oracle's equations in
  f32);
- every layer gates that one table per head and query row with its own
  ``gru_rel_pos_linear`` (head width -> 8) and ``gru_rel_pos_const``: on the
  layer's LayerNorm output ``x_h`` of head h, ``a, c = sigmoid(sum of
  gru_rel_pos_linear(x_h) in two groups of 4)`` and ``g = a (c const[h] - 1)
  + 2``;
- ``logits = q k^T / sqrt(d) + g[i] table[h, bucket(j - i)]``.

The encoder builds the bucket map (cached by length) and the ``[heads,
num_buckets]`` table once a forward and hands the ungated table to every
layer. On the ``"kernel"`` route (``wav2vec2.attention_route``) a layer calls
K2's bias mode (``ops.cuda.attention_kernel.mha(..., bias=)``), which never
forms the [B, H, T, T] bias; the ``"autograd"`` route computes the same math
in plain torch (``mha_plain``). The gate is computed in f32 from the
projection's output.

Parameter names are HF ``WavLMModel``'s (the positional conv holds the fused
``conv.weight``, as in ``wav2vec2.py``). Not served: int8 (``quant``), tensor
or pipeline parallelism of the layers, and recomputation in training.
``WavLMModel`` keeps ``Wav2Vec2Model``'s ``mode`` argument.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn

from avcer_tpu_torch.models.layers import Dropout, LayerNorm
from avcer_tpu_torch.models.wav2vec2 import (DROPOUT, Attention, Encoder, EncoderLayerStableLN,
                                             FeatureEncoder, FeatureProjection, FeedForward,
                                             PositionalConvEmbedding, Wav2Vec2Config,
                                             Wav2Vec2Model, attention_route)
from avcer_tpu_torch.ops.cuda.attention_kernel import mha, mha_plain


@dataclass(frozen=True)
class WavLMConfig(Wav2Vec2Config):
    """``Wav2Vec2Config``'s fields at WavLM-Large's published values
    (``microsoft/wavlm-large`` config.json: 24 layers, no conv bias), and the
    relative position bias's buckets and distance."""

    num_layers: int = 24
    conv_bias: bool = False
    num_buckets: int = 320
    max_bucket_distance: int = 800


def relative_buckets(t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """int32 [2t - 1]: the bucket of relative position ``r = j - i`` at
    ``r + t - 1``, as ``WavLMAttention._relative_positions_bucket`` computes
    it (f32 logarithm, truncated)."""
    rel = torch.arange(-(t - 1), t, dtype=torch.long)
    half = num_buckets // 2
    max_exact = half // 2
    out = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    large = torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
    large = (max_exact + large * (half - max_exact)).to(torch.long)
    large = torch.min(large, torch.full_like(large, half - 1))
    return (out + torch.where(rel < max_exact, rel, large)).to(torch.int32)


class WavLMAttention(Attention):
    """wav2vec2's attention projections, the gate's parameters and, in layer
    0, the bucket table."""

    def __init__(self, c: WavLMConfig, has_relative_position_bias: bool):
        super().__init__(c)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, c.num_heads, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(c.hidden_size // c.num_heads, 8)
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(c.num_buckets, c.num_heads)

    def gate(self, x: torch.Tensor) -> torch.Tensor:
        """[B H, T] f32 gate of each head and query row of the LayerNorm
        output ``x`` [B, T, hidden]."""
        b, t, d = x.shape
        h = self.num_heads
        p = self.gru_rel_pos_linear(x.reshape(b, t, h, d // h)).float()
        a, c = torch.sigmoid(p.view(b, t, h, 2, 4).sum(-1)).unbind(-1)
        g = a * (c * self.gru_rel_pos_const.view(1, 1, h).float() - 1.0) + 2.0
        return g.transpose(1, 2).reshape(b * h, t).contiguous()

    def forward(self, h: torch.Tensor, table: torch.Tensor,
                buckets: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            raise ValueError("WavLM's attention is not served tensor-parallel")
        b, t, d = h.shape

        def heads(x: torch.Tensor) -> torch.Tensor:  # -> [B, H, T, D]
            return x.reshape(b, t, self.num_heads, d // self.num_heads).transpose(1, 2).contiguous()

        q, k, v = heads(self.q_proj(h)), heads(self.k_proj(h)), heads(self.v_proj(h))
        bias = (table, buckets, self.gate(h))
        if attention_route(self, h) == "kernel":
            attn = mha(q, k, v, bias=bias)
        else:
            attn = mha_plain(q, k, v, bias)
        return self.out_proj(attn.transpose(1, 2).reshape(b, t, d))


class WavLMEncoderLayer(EncoderLayerStableLN):
    """Pre-LN layer (HF ``WavLMEncoderLayerStableLayerNorm``)."""

    def __init__(self, c: WavLMConfig, has_relative_position_bias: bool):
        nn.Module.__init__(self)
        self.layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attention = WavLMAttention(c, has_relative_position_bias)
        self.dropout = Dropout(DROPOUT)
        self.final_layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = FeedForward(c)

    def forward(self, x: torch.Tensor, table: torch.Tensor,
                buckets: torch.Tensor) -> torch.Tensor:
        x = x + self.dropout(self.attention(self.layer_norm(x), table, buckets))
        return x + self.feed_forward(self.final_layer_norm(x))


class WavLMEncoder(Encoder):
    """The positional conv, the layers (the bias table in layer 0) and the
    final LayerNorm (HF ``WavLMEncoderStableLayerNorm``)."""

    def __init__(self, c: WavLMConfig):
        nn.Module.__init__(self)
        self.pos_conv_embed = PositionalConvEmbedding(c)
        self.layers = nn.ModuleList(WavLMEncoderLayer(c, i == 0) for i in range(c.num_layers))
        self.layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = Dropout(DROPOUT)
        self.remat = False
        self.pipe = None
        self.num_buckets, self.max_bucket_distance = c.num_buckets, c.max_bucket_distance
        #: the bucket map of each (length, device)
        self._buckets: dict = {}

    def relative_bias(self, t: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(the ungated table [heads, num_buckets] f32, the bucket map [2t - 1]
        int32) of a forward over ``t`` frames."""
        key = (t, str(device))
        buckets = self._buckets.get(key)
        if buckets is None:
            buckets = self._buckets[key] = relative_buckets(
                t, self.num_buckets, self.max_bucket_distance).to(device)
        table = self.layers[0].attention.rel_attn_embed.weight.float().t().contiguous()
        return table, buckets

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.pipe is not None:
            raise ValueError("WavLM's layers are not served pipelined")
        h = self.pre_layers(h)
        table, buckets = self.relative_bias(h.shape[1], h.device)
        for layer in self.layers:
            h = layer(h, table, buckets)
        return self.layer_norm(h)


class WavLMModel(Wav2Vec2Model):
    """Normalised waveform [B, T] -> hidden states [B, F, hidden], with
    ``Wav2Vec2Model``'s modes."""

    def __init__(self, config: WavLMConfig | None = None):
        nn.Module.__init__(self)
        self.config = config or WavLMConfig()
        if self.config.quant:
            raise ValueError("WavLM is not served in int8")
        self.feature_extractor = FeatureEncoder(self.config)
        self.feature_projection = FeatureProjection(self.config)
        self.encoder = WavLMEncoder(self.config)

