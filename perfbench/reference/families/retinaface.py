"""RetinaFace (Deng et al. 2019) as biubug6's Pytorch_Retinaface builds it,
over the body the shape's ``body`` names:

- ``resnet50`` (``cfg_re50``): torchvision v1.5 bottlenecks (the stride on
  the 3x3 conv), a 7x7 stem ``stem`` wide and a 3x3 max pool, ``blocks``
  bottlenecks of ``planes`` a stage widened by ``expansion``, ReLU; the last
  three stages feed the FPN;
- ``mobilenet0.25`` (``cfg_mnet``): a 3x3 conv-BN stem ``stem`` = [width,
  stride], then each of ``stages`` a list of depthwise-separable [width,
  stride] convs, leaky ReLU ``leaky``; each stage feeds the FPN;

then the FPN (lateral 1x1s, nearest upsampling, merge 3x3s) and three SSH
modules ``width`` wide with the activation ``leaky`` (0: ReLU), BatchNorm eps
``eps``, and 1x1 heads of two anchors a cell for boxes, scores and five
landmarks (the anchors ``pipeline.priors`` lays out).

In an int8 configuration the bottleneck, FPN and SSH convs are quantised (of
the mobilenet body its pointwise convs only); the stem and the heads stay
exact.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from perfbench.reference.models import Ctx, act, batch_norm, conv2d

PROGRAM_CLASS = "RetinaFace"
ANCHORS = 2


def example(shape: dict, device) -> torch.Tensor:
    return torch.zeros(1, 64, 64, 3, device=device)


def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest to an exact size: source index floor(i * in / out)."""
    ri = (torch.arange(hw[0], device=x.device) * x.shape[2]) // hw[0]
    ci = (torch.arange(hw[1], device=x.device) * x.shape[3]) // hw[1]
    return x[:, :, ri][:, :, :, ci]


def _conv_bn(ctx: Ctx, name: str, x: torch.Tensor, cout: int, k: int, eps: float,
             stride: int = 1, leaky: Optional[float] = 0.0, quant: bool = False) -> torch.Tensor:
    """biubug6's ``conv_bn``: conv (no bias, padding (k - 1) / 2) ``.0``,
    BatchNorm ``.1``, then the activation."""
    y = conv2d(ctx, name + ".0", x, cout, k, stride, (k - 1) // 2, quant=quant)
    return act(batch_norm(ctx, name + ".1", y, eps), leaky)


def _tv_bottleneck(ctx: Ctx, name: str, x: torch.Tensor, planes: int, expansion: int,
                   stride: int, downsample: bool, eps: float, quant: bool) -> torch.Tensor:
    idn = x
    if downsample:
        idn = batch_norm(ctx, name + ".downsample.1",
                         conv2d(ctx, name + ".downsample.0", x, planes * expansion, 1, stride,
                                quant=quant), eps)
    h = F.relu(batch_norm(ctx, name + ".bn1", conv2d(ctx, name + ".conv1", x, planes, 1,
                                                     quant=quant), eps))
    h = F.relu(batch_norm(ctx, name + ".bn2", conv2d(ctx, name + ".conv2", h, planes, 3, stride,
                                                     1, quant=quant), eps))
    h = batch_norm(ctx, name + ".bn3", conv2d(ctx, name + ".conv3", h, planes * expansion, 1,
                                              quant=quant), eps, residual=True)
    return F.relu(h + idn)


def _r50_body(ctx: Ctx, x: torch.Tensor, shape: dict, quant: bool) -> list:
    eps, expansion = shape["eps"], shape["expansion"]
    h = F.relu(batch_norm(ctx, "body.bn1", conv2d(ctx, "body.conv1", x, shape["stem"], 7, 2, 3),
                          eps))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    outs, cin = [], shape["stem"]
    stages = list(zip(shape["blocks"], shape["planes"]))
    for li, (blocks, planes) in enumerate(stages):
        for bi in range(blocks):
            s = (1 if li == 0 else 2) if bi == 0 else 1
            h = _tv_bottleneck(ctx, f"body.layer{li + 1}.{bi}", h, planes, expansion, s,
                               bi == 0 and (s != 1 or cin != planes * expansion), eps, quant)
            cin = planes * expansion
        if li >= len(stages) - 3:
            outs.append(h)
    return outs


def _conv_dw(ctx: Ctx, name: str, x: torch.Tensor, cout: int, stride: int, leaky: float,
             eps: float, quant: bool) -> torch.Tensor:
    """MobileNetV1 ``conv_dw``: depthwise 3x3 ``.0`` (never quantised), BN
    ``.1``, leaky ReLU, pointwise ``.3``, BN ``.4``, leaky ReLU."""
    cin = x.shape[1]
    h = conv2d(ctx, name + ".0", x, cin, 3, stride, 1, groups=cin)
    h = act(batch_norm(ctx, name + ".1", h, eps), leaky)
    h = conv2d(ctx, name + ".3", h, cout, 1, quant=quant)
    return act(batch_norm(ctx, name + ".4", h, eps), leaky)


def _mnet_body(ctx: Ctx, x: torch.Tensor, shape: dict, quant: bool) -> list:
    eps, leaky = shape["eps"], shape["leaky"]
    width, stride = shape["stem"]
    h = _conv_bn(ctx, "body.stage1.0", x, width, 3, eps, stride, leaky=leaky)
    outs = []
    for si, stage in enumerate(shape["stages"]):
        for k, (o, s) in enumerate(stage, start=1 if si == 0 else 0):
            h = _conv_dw(ctx, f"body.stage{si + 1}.{k}", h, o, s, leaky, eps, quant)
        outs.append(h)
    return outs


def _ssh(ctx: Ctx, name: str, x: torch.Tensor, c: int, leaky: float, eps: float,
         quant: bool) -> torch.Tensor:
    c3 = _conv_bn(ctx, name + ".conv3X3", x, c // 2, 3, eps, leaky=None, quant=quant)
    c5_1 = _conv_bn(ctx, name + ".conv5X5_1", x, c // 4, 3, eps, leaky=leaky, quant=quant)
    c5 = _conv_bn(ctx, name + ".conv5X5_2", c5_1, c // 4, 3, eps, leaky=None, quant=quant)
    c7_2 = _conv_bn(ctx, name + ".conv7X7_2", c5_1, c // 4, 3, eps, leaky=leaky, quant=quant)
    c7 = _conv_bn(ctx, name + ".conv7x7_3", c7_2, c // 4, 3, eps, leaky=None, quant=quant)
    return F.relu(torch.cat([c3, c5, c7], dim=1))


def forward(ctx: Ctx, x: torch.Tensor, shape: dict, quant: bool = False):
    """Normalised BGR frames [B, H, W, 3] (pixel minus (104, 117, 123)) ->
    (loc [B, A, 4], conf [B, A, 2] softmaxed, landms [B, A, 10]), anchor
    rows in (level, h, w, anchor) order."""
    x = x.permute(0, 3, 1, 2)
    if shape["body"] == "resnet50":
        feats = _r50_body(ctx, x, shape, quant)
    elif shape["body"] == "mobilenet0.25":
        feats = _mnet_body(ctx, x, shape, quant)
    else:
        raise ValueError(f"no RetinaFace body {shape['body']!r}")
    c, leaky, eps = shape["width"], shape["leaky"], shape["eps"]
    o = [_conv_bn(ctx, f"fpn.output{i + 1}", f, c, 1, eps, leaky=leaky, quant=quant)
         for i, f in enumerate(feats)]
    o2 = _conv_bn(ctx, "fpn.merge2", o[1] + upsample_nearest(o[2], o[1].shape[2:]), c, 3, eps,
                  leaky=leaky, quant=quant)
    o1 = _conv_bn(ctx, "fpn.merge1", o[0] + upsample_nearest(o2, o[0].shape[2:]), c, 3, eps,
                  leaky=leaky, quant=quant)
    ssh = [_ssh(ctx, f"ssh{i + 1}", f, c, leaky, eps, quant)
           for i, f in enumerate((o1, o2, o[2]))]

    def head(kind: str, width: int) -> torch.Tensor:
        outs = []
        for i, f in enumerate(ssh):
            y = conv2d(ctx, f"{kind}.{i}.conv1x1", f, ANCHORS * width, 1,
                       bias=True).permute(0, 2, 3, 1)
            outs.append(y.reshape(y.shape[0], -1, width))
        return torch.cat(outs, dim=1)

    return (head("BboxHead", 4), torch.softmax(head("ClassHead", 2), dim=-1),
            head("LandmarkHead", 10))
