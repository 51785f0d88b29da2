"""Static emotion CNN (avcer_tpu/models/emotion_resnet.py): the reference's
TF-flavoured ResNet50.

- TF 'same' stem padding (asymmetric), 7x7/s2, then a VALID 3x3/2 max pool;
- bottlenecks with the stride on the first 1x1 conv and on the projection
  (TF v1), 3x3 'same', BN eps ``BN_EPS``;
- head: spatial mean -> fc1 (2048 -> 512) -> ReLU -> fc2; the ReLU'd fc1
  output (512) is the LSTM's feature.

Parameter names follow ``TwinEmotionResNet50`` in tests/torch_twins.py.
Public layout is NHWC. ``fused`` runs the bottleneck chains through
``ops.cuda.fused_resnet_kernel.fused_chain`` over the same state dict: chunks
of three blocks, of one where planes >= 512; the stride-2 entries stay cuDNN
sections unless ``fused_entries`` fuses those of layers 2 and 3 ("s2pre");
layer4's entry is never fused. Tensors keep the NCHW shape between sections
(see ``models.retinaface.fused_section``).

``quant`` is the JAX package's int8 variant over the same state dict: the
stem and every bottleneck conv are ``layers.QConv``; the fc head stays exact.
With ``fused`` the chains run the fused kernel's int8 mode; calibration
forwards (``layers.calibrating``) always run the unfused modules, and so does
a model in ``training``, as the JAX package fuses only when not training
(avcer_tpu/models/emotion_resnet.py:161). In ``training`` every BatchNorm
takes batch statistics and moves its running ones with torch's momentum
``BN_MOMENTUM`` = 0.01 (the reference passes 0.99 to ``nn.BatchNorm2d``,
which the JAX package reads as the weight of the old value).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from avcer_tpu_torch.models.layers import BatchNorm, FoldCache
from avcer_tpu_torch.models.retinaface import fold_pairs, fused_section, make_conv

BN_EPS = 1e-3
BN_MOMENTUM = 0.01


def same_pad(i: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """TF 'same' padding (lo, hi) for one spatial dim."""
    total = max((-(-i // s) - 1) * s + (k - 1) * d + 1 - i, 0)
    return total // 2, total - total // 2


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False,
                 quant: bool = False):
        super().__init__()
        self.conv1 = make_conv(in_ch, planes, 1, stride, 0, quant)
        self.batch_norm1 = BatchNorm(planes, BN_EPS, BN_MOMENTUM)
        self.conv2 = make_conv(planes, planes, 3, 1, 1, quant)
        self.batch_norm2 = BatchNorm(planes, BN_EPS, BN_MOMENTUM)
        self.conv3 = make_conv(planes, planes * 4, 1, 1, 0, quant)
        self.batch_norm3 = BatchNorm(planes * 4, BN_EPS, BN_MOMENTUM)
        self.i_downsample = (
            nn.Sequential(make_conv(in_ch, planes * 4, 1, stride, 0, quant),
                          BatchNorm(planes * 4, BN_EPS, BN_MOMENTUM))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idn = x if self.i_downsample is None else self.i_downsample(x)
        h = F.relu(self.batch_norm1(self.conv1(x)))
        h = F.relu(self.batch_norm2(self.conv2(h)))
        return F.relu(self.batch_norm3(self.conv3(h)) + idn)

    def fold_pairs(self) -> list:
        """(conv, BatchNorm) of conv1, conv2, conv3 and the projection (BN eps
        ``BN_EPS``, carried by each BatchNorm)."""
        pairs = [(self.conv1, self.batch_norm1), (self.conv2, self.batch_norm2),
                 (self.conv3, self.batch_norm3)]
        if self.i_downsample is not None:
            pairs.append((self.i_downsample[0], self.i_downsample[1]))
        return pairs

    def folded(self, dtype: torch.dtype) -> list[torch.Tensor]:
        """Flat ``(w, inv, shift)`` of conv1, conv2, conv3 and the projection."""
        return fold_pairs(self.fold_pairs(), dtype)[0]


class EmotionResNet50(FoldCache):
    """Normalised BGR crops [B, H, W, 3] -> (logits [B, C], features [B, 512])
    with features = relu(fc1); with ``return_act4`` also layer4's output
    [B, 2048, h, w] (NCHW; fused, K3's), for Grad-CAM."""

    def __init__(self, num_classes: int = 7, fused: bool = False, fused_entries: bool = False,
                 quant: bool = False):
        super().__init__()
        self.fused = fused
        self.fused_entries = fused_entries
        self.quant = quant
        # in int8 the stem is quantised too (unlike the detector's)
        self.conv_layer_s2_same = make_conv(3, 64, 7, 2, 0, quant)
        self.batch_norm1 = BatchNorm(64, BN_EPS, BN_MOMENTUM)
        in_ch = 64
        for li, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                layer.append(Bottleneck(in_ch, planes, s,
                                        bi == 0 and (s != 1 or in_ch != planes * 4), quant))
                in_ch = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.fc1 = nn.Linear(2048, 512)
        self.fc2 = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor, return_act4: bool = False) -> tuple[torch.Tensor, ...]:
        x = x.permute(0, 3, 1, 2).to(self.fc1.weight.dtype)  # the fc head is never int8
        ph = same_pad(x.shape[2], 7, 2)
        pw = same_pad(x.shape[3], 7, 2)
        x = F.pad(x, [pw[0], pw[1], ph[0], ph[1]])
        x = F.relu(self.batch_norm1(self.conv_layer_s2_same(x)))
        x = F.max_pool2d(x, 3, stride=2)
        for li in range(4):
            layer = getattr(self, f"layer{li + 1}")
            if not self.fused or self.calibrating or self.training:
                x = layer(x)
                continue
            start = 0
            if li > 0 and not (self.fused_entries and li < 3):
                x = layer[0](x)  # the stride-2 entry stays a cuDNN section
                start = 1
            tail = list(range(start, len(layer)))
            chunk_n = 1 if layer[0].conv1.weight.shape[0] >= 512 else 3
            while tail:
                chunk, tail = tail[:chunk_n], tail[chunk_n:]
                kinds = tuple(("s2pre" if li > 0 else "ds") if bi == 0 else "id" for bi in chunk)
                x = fused_section(self, x, layer, li, chunk, kinds)
        features = F.relu(self.fc1(x.mean(dim=(2, 3))))
        if return_act4:
            return self.fc2(features), features, x
        return self.fc2(features), features
