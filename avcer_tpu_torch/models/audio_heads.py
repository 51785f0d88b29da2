"""Audio emotion head ExprModel V3 (avcer_tpu/models/audio_heads.py):
wav2vec2 -> TransformerLayer(32 heads) -> TransformerLayer(16 heads) ->
time downsample (Conv1d k5 s3 d2 -> BN -> MaxPool1d(5) -> ReLU -> Conv1d k3
-> BN -> mean over time -> ReLU) -> Linear(hidden, C).

Parameter names follow ``TwinExprModel`` (``time_downsample`` keeps the
reference Sequential's indices 0, 1, 4, 5). V1 (GRU) and V2 are not ported
yet.
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

    def __init__(self, num_classes: int = 8, wav2vec2_config: Wav2Vec2Config | None = None):
        super().__init__()
        self.wav2vec2 = Wav2Vec2Model(wav2vec2_config)
        f = self.wav2vec2.config.hidden_size
        self.tl1 = TransformerLayer(f, 32)
        self.tl2 = TransformerLayer(f, 16)
        self.time_downsample = nn.Sequential(
            nn.Conv1d(f, f, 5, stride=3, dilation=2), BatchNorm(f), _MaxPool(),
            nn.ReLU(), nn.Conv1d(f, f, 3), BatchNorm(f), _MeanReLU(),
        )
        self.feature_downsample = nn.Linear(f, num_classes)

    def forward(self, wav: torch.Tensor, w2v_mode: str = "full") -> torch.Tensor:
        """``w2v_mode`` is ``Wav2Vec2Model.forward``'s ``mode``: with
        ``"features_only"`` the conv features come back and the head does not
        run; with ``"from_features"`` ``wav`` holds such features."""
        h = self.wav2vec2(wav, mode=w2v_mode)
        if w2v_mode == "features_only":
            return h
        h = self.tl2(self.tl1(h))
        if h.shape[1] < 51:
            # the VALID conv/pool stack would leave an empty time axis
            raise ValueError(
                f"time downsample needs >= 51 frames, got {h.shape[1]} "
                "(a 4 s / 16 kHz window gives 199)")
        return self.feature_downsample(self.time_downsample(h.transpose(1, 2)))
