"""ExprModel V3 of ElenaRyumina/AVCER over wav2vec2 (Baevski et al. 2020) as
Hugging Face's ``Wav2Vec2Model`` builds the large robust checkpoints
(audeering's ``wav2vec2-large-robust-12-ft-emotion-msp-dim``):

- the layer-norm conv feature extractor: convs of widths ``conv_dim``,
  kernels ``conv_kernel`` and strides ``conv_stride``, each with a LayerNorm
  and GELU;
- the feature projection to ``hidden_size``, the grouped positional conv
  (``num_conv_pos_embeddings`` taps, ``num_conv_pos_embedding_groups``
  groups), ``num_layers`` pre-LN encoder layers of ``num_heads`` heads and
  a ``intermediate_size`` feed-forward, and a final LayerNorm (eps
  ``layer_norm_eps``);
- the V3 head: two post-LN transformer layers of ``head_heads`` heads with a
  sinusoidal encoding, the conv / BatchNorm / max-pool time downsample and a
  linear layer to ``num_classes``.

In an int8 configuration the extractor's convs past the first and the
encoder layers' q, k, v, out and feed-forward products are quantised.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.models import (Ctx, attention, batch_norm, conv1d, layer_norm,
                                        linear)

PROGRAM_CLASS = "ExprModel"


def example(shape: dict, device) -> torch.Tensor:
    return torch.zeros(1, 64000, device=device)


def frames_per_window(samples: int, shape: dict) -> int:
    """Conv feature frames of a window of ``samples``."""
    n = samples
    for k, s in zip(shape["conv_kernel"], shape["conv_stride"]):
        n = (n - k) // s + 1
    return n


def hop(shape: dict) -> int:
    """Samples between two conv feature frames."""
    return int(np.prod(shape["conv_stride"]))


def features(ctx: Ctx, wav: torch.Tensor, shape: dict, quant: bool = False) -> torch.Tensor:
    """Normalised waveform [B, T] -> conv features [B, F, conv_dim[-1]]."""
    h = wav[:, None, :]
    for i, (c, k, s) in enumerate(zip(shape["conv_dim"], shape["conv_kernel"],
                                      shape["conv_stride"])):
        name = f"wav2vec2.feature_extractor.conv_layers.{i}"
        h = conv1d(ctx, name + ".conv", h, c, k, s, quant=quant and i > 0)
        h = F.gelu(layer_norm(ctx, name + ".layer_norm", h.transpose(1, 2),
                              shape["layer_norm_eps"])).transpose(1, 2)
    return h.transpose(1, 2)


def encode(ctx: Ctx, feats: torch.Tensor, shape: dict, quant: bool = False) -> torch.Tensor:
    """Conv features [B, F, conv_dim[-1]] -> hidden states [B, F, hidden]."""
    eps, d = shape["layer_norm_eps"], shape["hidden_size"]
    h = linear(ctx, "wav2vec2.feature_projection.projection",
               layer_norm(ctx, "wav2vec2.feature_projection.layer_norm", feats, eps), d)
    k = shape["num_conv_pos_embeddings"]
    pos = conv1d(ctx, "wav2vec2.encoder.pos_conv_embed.conv", h.transpose(1, 2), d, k,
                 padding=k // 2, groups=shape["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    for li in range(shape["num_layers"]):
        name = f"wav2vec2.encoder.layers.{li}"
        x = layer_norm(ctx, name + ".layer_norm", h, eps)
        a = name + ".attention"
        attn = attention(linear(ctx, a + ".q_proj", x, d, quant=quant),
                         linear(ctx, a + ".k_proj", x, d, quant=quant),
                         linear(ctx, a + ".v_proj", x, d, quant=quant), shape["num_heads"])
        h = h + linear(ctx, a + ".out_proj", attn, d, quant=quant)
        x = layer_norm(ctx, name + ".final_layer_norm", h, eps)
        f = name + ".feed_forward"
        x = F.gelu(linear(ctx, f + ".intermediate_dense", x, shape["intermediate_size"],
                          quant=quant))
        h = h + linear(ctx, f + ".output_dense", x, d, quant=quant)
    return layer_norm(ctx, "wav2vec2.encoder.layer_norm", h, eps)


def sinusoidal_encoding(d: int, t: int, device) -> torch.Tensor:
    position = np.arange(t, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((t, d), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def _transformer_layer(ctx: Ctx, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Post-LN layer of the audio head: the sinusoidal encoding added once and
    used as Q, K and V, bias-free projections, residual on Q."""
    d = x.shape[-1]
    q = x + sinusoidal_encoding(d, x.shape[1], x.device)
    a = name + ".self_attention"
    attn = attention(linear(ctx, a + ".query_w", q, d, bias=False),
                     linear(ctx, a + ".keys_w", q, d, bias=False),
                     linear(ctx, a + ".values_w", q, d, bias=False), heads)
    h = layer_norm(ctx, name + ".add_norm_after_attention.layer_norm",
                   linear(ctx, a + ".ff_layer_after_concat", attn, d, bias=False) + q, 1e-5)
    f = name + ".feed_forward"
    ff = linear(ctx, f + ".layer_2", F.relu(linear(ctx, f + ".layer_1", h, d)), d)
    return layer_norm(ctx, name + ".add_norm_after_ff.layer_norm", ff + h, 1e-5)


def head(ctx: Ctx, h: torch.Tensor, shape: dict) -> torch.Tensor:
    """The V3 head: hidden states [B, F, hidden] -> logits [B, num_classes]."""
    for i, heads in enumerate(shape["head_heads"]):
        h = _transformer_layer(ctx, f"tl{i + 1}", h, heads)
    d = h.shape[-1]
    y = conv1d(ctx, "time_downsample.0", h.transpose(1, 2), d, 5, stride=3, dilation=2)
    y = F.relu(F.max_pool1d(batch_norm(ctx, "time_downsample.1", y, 1e-5), 5))
    y = batch_norm(ctx, "time_downsample.5", conv1d(ctx, "time_downsample.4", y, d, 3), 1e-5)
    return linear(ctx, "feature_downsample", F.relu(y.mean(dim=-1)), shape["num_classes"])


def forward(ctx: Ctx, wav: torch.Tensor, shape: dict, quant: bool = False) -> torch.Tensor:
    """Normalised 4 s windows [B, 64000] -> logits [B, num_classes]."""
    return head(ctx, encode(ctx, features(ctx, wav, shape, quant), shape, quant), shape)
