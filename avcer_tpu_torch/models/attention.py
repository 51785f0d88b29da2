"""The audio heads' post-LN transformer layer (avcer_tpu/models/attention.py).

Sinusoidal positional encoding added once and shared by Q, K and V (the
reference's three applications to one stream are the same in eval mode),
bias-free projections, per-head scaled dot attention with an f32 softmax,
post-LN residual blocks, and a ReLU FFN with hidden == input width.
Parameter names follow ``TwinTransformerLayer``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from avcer_tpu_torch.models.layers import LayerNorm, scaled_dot_attention


def sinusoidal_positional_encoding(d_model: int, max_len: int = 5000) -> np.ndarray:
    """pe[pos, 2i] = sin(pos * exp(-2i ln(1e4)/d)), pe[pos, 2i+1] = cos(...)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


class MultiHeadAttention(nn.Module):
    def __init__(self, input_dim: int, num_heads: int):
        super().__init__()
        if input_dim % num_heads:
            raise ValueError("input_dim must be divisible by num_heads")
        self.num_heads = num_heads
        self.query_w = nn.Linear(input_dim, input_dim, bias=False)
        self.keys_w = nn.Linear(input_dim, input_dim, bias=False)
        self.values_w = nn.Linear(input_dim, input_dim, bias=False)
        self.ff_layer_after_concat = nn.Linear(input_dim, input_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape

        def split(y: torch.Tensor) -> torch.Tensor:
            return y.reshape(b, t, self.num_heads, d // self.num_heads).transpose(1, 2)

        out = scaled_dot_attention(split(self.query_w(x)), split(self.keys_w(x)),
                                   split(self.values_w(x)), dtype=x.dtype)
        return self.ff_layer_after_concat(out.transpose(1, 2).reshape(b, t, d))


class AddAndNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.layer_norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(x + residual)


class PositionWiseFeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.layer_1 = nn.Linear(dim, dim)
        self.layer_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_2(F.relu(self.layer_1(x)))


class TransformerLayer(nn.Module):
    def __init__(self, input_dim: int, num_heads: int):
        super().__init__()
        self.self_attention = MultiHeadAttention(input_dim, num_heads)
        self.add_norm_after_attention = AddAndNorm(input_dim)
        self.add_norm_after_ff = AddAndNorm(input_dim)
        self.feed_forward = PositionWiseFeedForward(input_dim)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positional_encoding(input_dim)),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe_x = (x.float() + self.pe[: x.shape[1]]).to(x.dtype)
        h = self.add_norm_after_attention(self.self_attention(pe_x), pe_x)
        return self.add_norm_after_ff(self.feed_forward(h), h)
