"""ExprModel V3 of ElenaRyumina/AVCER over WavLM-Large (Chen et al. 2022,
"WavLM: Large-Scale Self-Supervised Pre-Training for Full Stack Speech
Processing", arXiv:2110.13900) as Hugging Face's ``WavLMModel`` builds
``microsoft/wavlm-large`` (``do_stable_layer_norm``):

- wav2vec2's layer-norm conv feature extractor (``conv_bias`` as published),
  feature projection and grouped positional conv;
- ``num_layers`` pre-LN encoder layers whose self-attention adds a gated
  relative position bias to the logits after the division by sqrt(d):
  layer 0's ``rel_attn_embed`` ([num_buckets, heads]) read at the bucket of
  each relative position j - i (half the buckets for j - i > 0, exact below
  a quarter of them, logarithmic up to ``max_bucket_distance``, computed in
  float32 and truncated), and each layer's gate per head and query row from
  its LayerNorm output: ``a, c = sigmoid(gru_rel_pos_linear(x_h) summed in
  two groups of 4)``, ``g = a (c gru_rel_pos_const[h] - 1) + 2``;
- the V3 head of ``wav2vec2_expr_v3`` on the 1024-wide states.

In an int8 configuration the extractor's convs past the first
and the encoder layers' q, k, v, out and feed-forward products are
quantised; the gate's projection is not.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.families.wav2vec2_expr_v3 import (example, frames_per_window, head,
                                                           hop)
from perfbench.reference.models import Ctx, conv1d, layer_norm, linear

PROGRAM_CLASS = "ExprModel"

__all__ = ["PROGRAM_CLASS", "example", "features", "encode", "head", "forward",
           "frames_per_window", "hop"]


def features(ctx: Ctx, wav: torch.Tensor, shape: dict, quant: bool = False) -> torch.Tensor:
    """Normalised waveform [B, T] -> conv features [B, F, conv_dim[-1]]."""
    h = wav[:, None, :]
    for i, (c, k, s) in enumerate(zip(shape["conv_dim"], shape["conv_kernel"],
                                      shape["conv_stride"])):
        name = f"wav2vec2.feature_extractor.conv_layers.{i}"
        h = conv1d(ctx, name + ".conv", h, c, k, s, bias=shape["conv_bias"],
                   quant=quant and i > 0)
        h = F.gelu(layer_norm(ctx, name + ".layer_norm", h.transpose(1, 2),
                              shape["layer_norm_eps"])).transpose(1, 2)
    return h.transpose(1, 2)


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """The bucket of each relative position (long) in ``rel``."""
    half = num_buckets // 2
    exact = half // 2
    out = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    large = torch.log(rel.float() / exact) / math.log(max_distance / exact) * (half - exact)
    large = torch.min((exact + large).to(torch.long), torch.full_like(rel, half - 1))
    return out + torch.where(rel < exact, rel, large)


def position_bias(table: torch.Tensor, t: int, shape: dict) -> torch.Tensor:
    """[H, T, T]: ``table[bucket(j - i), h]`` (the ungated bias)."""
    rel = torch.arange(-(t - 1), t, dtype=torch.long)
    b = bucket(rel, shape["num_buckets"], shape["max_bucket_distance"]).to(table.device)
    pos = torch.arange(t, device=table.device)
    return table[b[pos[None, :] - pos[:, None] + t - 1]].permute(2, 0, 1)


def gate(ctx: Ctx, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, H, T] gate of the layer's LayerNorm output ``x`` [B, T, D]."""
    b, t, d = x.shape
    xh = x.reshape(b, t, heads, d // heads).transpose(1, 2)
    p = linear(ctx, name + ".gru_rel_pos_linear", xh, 8).view(b, heads, t, 2, 4).sum(-1)
    a, c = torch.sigmoid(p).unbind(-1)
    const = ctx.p(name + ".gru_rel_pos_const", (1, heads, 1, 1), "ln_weight", x)
    return a * (c * const[:, :, :, 0] - 1.0) + 2.0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              bias: torch.Tensor) -> torch.Tensor:
    """Softmax attention of [B, T, D] over ``heads`` heads with ``bias``
    [B, H, T, T] added to the logits after the division by sqrt(d)."""
    b, t, d = q.shape

    def split(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(b, t, heads, d // heads).transpose(1, 2)

    logits = split(q) @ split(k).transpose(-1, -2) / math.sqrt(d // heads) + bias
    out = torch.softmax(logits, dim=-1) @ split(v)
    return out.transpose(1, 2).reshape(b, t, d)


def encode(ctx: Ctx, feats: torch.Tensor, shape: dict, quant: bool = False) -> torch.Tensor:
    """Conv features [B, F, conv_dim[-1]] -> hidden states [B, F, hidden]."""
    eps, d, heads = shape["layer_norm_eps"], shape["hidden_size"], shape["num_heads"]
    h = linear(ctx, "wav2vec2.feature_projection.projection",
               layer_norm(ctx, "wav2vec2.feature_projection.layer_norm", feats, eps), d)
    k = shape["num_conv_pos_embeddings"]
    pos = conv1d(ctx, "wav2vec2.encoder.pos_conv_embed.conv", h.transpose(1, 2), d, k,
                 padding=k // 2, groups=shape["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    table = ctx.p("wav2vec2.encoder.layers.0.attention.rel_attn_embed.weight",
                  (shape["num_buckets"], heads), "kernel", h)
    rel = position_bias(table, h.shape[1], shape)
    for li in range(shape["num_layers"]):
        name = f"wav2vec2.encoder.layers.{li}"
        x = layer_norm(ctx, name + ".layer_norm", h, eps)
        a = name + ".attention"
        g = gate(ctx, a, x, heads)
        attn = attention(linear(ctx, a + ".q_proj", x, d, quant=quant),
                         linear(ctx, a + ".k_proj", x, d, quant=quant),
                         linear(ctx, a + ".v_proj", x, d, quant=quant), heads,
                         g[..., None] * rel[None])
        h = h + linear(ctx, a + ".out_proj", attn, d, quant=quant)
        x = layer_norm(ctx, name + ".final_layer_norm", h, eps)
        f = name + ".feed_forward"
        x = F.gelu(linear(ctx, f + ".intermediate_dense", x, shape["intermediate_size"],
                          quant=quant))
        h = h + linear(ctx, f + ".output_dense", x, d, quant=quant)
    return layer_norm(ctx, "wav2vec2.encoder.layer_norm", h, eps)


def forward(ctx: Ctx, wav: torch.Tensor, shape: dict, quant: bool = False) -> torch.Tensor:
    """Normalised 4 s windows [B, 64000] -> logits [B, num_classes]."""
    return head(ctx, encode(ctx, features(ctx, wav, shape, quant), shape, quant), shape)
