"""The static emotion CNN of ElenaRyumina/AVCER: a TF-flavoured ResNet50
(the stride on the first 1x1 conv of a stage, TF "same" padding of the 7x7
stem ``stem`` wide, BatchNorm eps ``eps``), ``blocks`` bottlenecks of
``planes`` a stage widened by ``expansion``, then global mean pooling, fc
to ``features`` (its ReLU'd output is the feature) and fc to
``num_classes``.

In an int8 configuration every conv is quantised, not the fc head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.models import Ctx, batch_norm, conv2d, linear

PROGRAM_CLASS = "EmotionResNet50"


def example(shape: dict, device) -> torch.Tensor:
    return torch.zeros(1, 224, 224, 3, device=device)


def same_pad(i: int, k: int, s: int) -> tuple[int, int]:
    """TF "same" padding (lo, hi) of one spatial dim."""
    total = max((-(-i // s) - 1) * s + k - i, 0)
    return total // 2, total - total // 2


def forward(ctx: Ctx, x: torch.Tensor, shape: dict, quant: bool = False):
    """Crops [B, 224, 224, 3] minus the VGGFace2 BGR means -> (logits
    [B, num_classes], features [B, features] = relu(fc1))."""
    eps, expansion = shape["eps"], shape["expansion"]
    x = x.permute(0, 3, 1, 2)
    ph, pw = same_pad(x.shape[2], 7, 2), same_pad(x.shape[3], 7, 2)
    x = F.pad(x, [pw[0], pw[1], ph[0], ph[1]])
    x = F.relu(batch_norm(ctx, "batch_norm1",
                          conv2d(ctx, "conv_layer_s2_same", x, shape["stem"], 7, 2, quant=quant),
                          eps))
    x = F.max_pool2d(x, 3, stride=2)
    cin = shape["stem"]
    for li, (blocks, planes) in enumerate(zip(shape["blocks"], shape["planes"])):
        for bi in range(blocks):
            s = (1 if li == 0 else 2) if bi == 0 else 1
            name = f"layer{li + 1}.{bi}"
            idn = x
            if bi == 0 and (s != 1 or cin != planes * expansion):
                idn = batch_norm(ctx, name + ".i_downsample.1",
                                 conv2d(ctx, name + ".i_downsample.0", x, planes * expansion, 1,
                                        s, quant=quant), eps)
            h = F.relu(batch_norm(ctx, name + ".batch_norm1",
                                  conv2d(ctx, name + ".conv1", x, planes, 1, s, quant=quant), eps))
            h = F.relu(batch_norm(ctx, name + ".batch_norm2",
                                  conv2d(ctx, name + ".conv2", h, planes, 3, 1, 1, quant=quant),
                                  eps))
            h = batch_norm(ctx, name + ".batch_norm3",
                           conv2d(ctx, name + ".conv3", h, planes * expansion, 1, quant=quant),
                           eps, residual=True)
            x = F.relu(h + idn)
            cin = planes * expansion
    feats = F.relu(linear(ctx, "fc1", x.mean(dim=(2, 3)), shape["features"]))
    return linear(ctx, "fc2", feats, shape["num_classes"]), feats
