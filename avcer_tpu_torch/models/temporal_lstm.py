"""Dynamic temporal model (avcer_tpu/models/temporal_lstm.py):
LSTM(512 -> 512) -> LSTM(512 -> 256) -> Linear(256 -> C) on the last step.

torch's gate order (i, f, g, o) with both biases is the JAX package's, so
``nn.LSTM`` is the model as it stands; names follow ``TwinTemporalLSTM``.
The LSTM runs in f32 whatever the pipeline's compute dtype: its windows are
[S, 10, 512], a negligible cost, and f32 avoids relying on a bf16 RNN path.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class TemporalLSTM(nn.Module):
    """[B, 10, 512] feature windows -> [B, num_classes] raw logits (f32)."""

    def __init__(self, num_classes: int = 7):
        super().__init__()
        self.lstm1 = nn.LSTM(512, 512, batch_first=True)
        self.lstm2 = nn.LSTM(512, 256, batch_first=True)
        self.fc = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _ = self.lstm1(x.float())
        x, _ = self.lstm2(x)
        return self.fc(x[:, -1, :])
