"""Audio emotion heads ExprModel V1 / V2 / V3 (avcer_tpu/models/audio_heads.py),
7 or 8 classes:

- V1: wav2vec2 -> 2-layer GRU(hidden -> 256) -> time downsample of width 256
  -> Linear(256, C);
- V2 and V3 (one graph; they differ only in which layers were fine-tuned):
  wav2vec2 -> TransformerLayer(32 heads) -> TransformerLayer(16 heads) ->
  time downsample -> Linear(hidden, C);
- time downsample: Conv1d k5 s3 d2 -> BN -> MaxPool1d(5) -> ReLU -> Conv1d k3
  -> BN -> mean over time -> ReLU.

Parameter names follow ``TwinExprModel`` (``gru`` is the reference's
``nn.GRU``; ``time_downsample`` keeps the reference Sequential's indices 0, 1,
4, 5), so release files load strictly. The GRU is the JAX package's
``lax.scan``, not a TPU kernel: it runs as the library's ``nn.GRU`` in f32
(its weights stay f32 under ``cast_compute``), on the card cuDNN's.

``forward`` follows ``module.training`` as the JAX package's
``deterministic=not train`` does: dropout in the encoder and the transformer
layers, batch statistics in the time downsample's BatchNorms (momentum 0.1).
``return_features`` also gives the pooled features (the head's input).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from avcer_tpu_torch.models.attention import TransformerLayer
from avcer_tpu_torch.models.layers import BatchNorm
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model


class _MaxPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool1d(x, 5)


class _MeanReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x.mean(dim=-1))


class ExprModel(nn.Module):
    """Normalised waveform [B, samples] -> logits [B, num_classes]."""

    def __init__(self, variant: str = "v3", num_classes: int = 8,
                 wav2vec2_config: Wav2Vec2Config | None = None):
        super().__init__()
        self.variant = variant
        self.wav2vec2 = Wav2Vec2Model(wav2vec2_config)
        hidden = self.wav2vec2.config.hidden_size
        if variant == "v1":
            self.gru = nn.GRU(hidden, 256, num_layers=2, batch_first=True)
            f = 256
        elif variant in ("v2", "v3"):
            self.tl1 = TransformerLayer(hidden, 32)
            self.tl2 = TransformerLayer(hidden, 16)
            f = hidden
        else:
            raise ValueError(f"unknown ExprModel variant {variant!r}")
        self.time_downsample = nn.Sequential(
            nn.Conv1d(f, f, 5, stride=3, dilation=2), BatchNorm(f), _MaxPool(),
            nn.ReLU(), nn.Conv1d(f, f, 3), BatchNorm(f), _MeanReLU(),
        )
        self.feature_downsample = nn.Linear(f, num_classes)

    def forward(self, wav: torch.Tensor, w2v_mode: str = "full",
                return_features: bool = False):
        """``w2v_mode`` is ``Wav2Vec2Model.forward``'s ``mode``: with
        ``"features_only"`` the conv features come back and the head does not
        run; with ``"from_features"`` ``wav`` holds such features. With
        ``return_features``: (logits, pooled features [B, F])."""
        h = self.wav2vec2(wav, mode=w2v_mode)
        if w2v_mode == "features_only":
            return h
        if self.variant == "v1":
            h = self.gru(h.float())[0].to(h.dtype)
        else:
            h = self.tl2(self.tl1(h))
        if h.shape[1] < 51:
            # the VALID conv/pool stack would leave an empty time axis
            raise ValueError(
                f"time downsample needs >= 51 frames, got {h.shape[1]} "
                "(a 4 s / 16 kHz window gives 199)")
        pooled = self.time_downsample(h.transpose(1, 2))
        logits = self.feature_downsample(pooled)
        return (logits, pooled) if return_features else logits
