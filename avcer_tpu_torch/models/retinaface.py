"""RetinaFace-r50 face detector (avcer_tpu/models/retinaface.py): the
torchvision v1.5 ResNet50 body, FPN, SSH context modules and 1x1 heads.

Parameter names follow the reference torch module (``TwinRetinaFace`` with
``TVStyleResNet50Body`` in tests/torch_twins.py), so a ``Resnet50_Final.pth``
state dict loads strictly. Public layout is the JAX package's: NHWC input,
``(loc [B, A, 4], conf [B, A, 2], landms [B, A, 10])`` with anchor rows in
(level, h, w, anchor) order, conf softmaxed in f32. Inside, convolutions run
NCHW in the weights' dtype. The mobilenet, space-to-depth, fused and int8
variants are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from avcer_tpu_torch.models.layers import BatchNorm


class ConvBN(nn.Sequential):
    """Conv (no bias) -> BatchNorm -> optional (leaky) ReLU; state names
    ``0.weight`` and ``1.*`` like the reference's ``conv_bn`` Sequentials."""

    def __init__(self, inp: int, oup: int, k: int = 3, stride: int = 1,
                 leaky: float = 0.0, relu: bool = True):
        super().__init__(nn.Conv2d(inp, oup, k, stride, (k - 1) // 2, bias=False),
                         BatchNorm(oup))
        self.act = relu
        self.leaky = leaky

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[1](self[0](x))
        if not self.act:
            return x
        return F.leaky_relu(x, self.leaky) if self.leaky else F.relu(x)


class TVBottleneck(nn.Module):
    """torchvision Bottleneck: stride on the 3x3 conv (v1.5), BN eps 1e-5."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (
            nn.Sequential(nn.Conv2d(in_ch, planes * 4, 1, stride=stride, bias=False),
                          BatchNorm(planes * 4))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idn = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + idn)


class ResNet50Body(nn.Module):
    """torchvision-resnet50 backbone emitting layer2/3/4 features."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for li, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                layer.append(TVBottleneck(in_ch, planes, s,
                                          bi == 0 and (s != 1 or in_ch != planes * 4)))
                in_ch = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        h = self.layer1(h)
        c2 = self.layer2(h)
        c3 = self.layer3(c2)
        return c2, c3, self.layer4(c3)


def upsample_nearest_to(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """torch nearest to an exact size: source index floor(i * in / out)."""
    h, w = x.shape[2], x.shape[3]
    ri = (torch.arange(hw[0], device=x.device) * h) // hw[0]
    ci = (torch.arange(hw[1], device=x.device) * w) // hw[1]
    return x[:, :, ri][:, :, :, ci]


class FPN(nn.Module):
    def __init__(self, in_list: tuple[int, int, int], out_ch: int):
        super().__init__()
        leaky = 0.1 if out_ch <= 64 else 0.0
        self.output1 = ConvBN(in_list[0], out_ch, k=1, leaky=leaky)
        self.output2 = ConvBN(in_list[1], out_ch, k=1, leaky=leaky)
        self.output3 = ConvBN(in_list[2], out_ch, k=1, leaky=leaky)
        self.merge1 = ConvBN(out_ch, out_ch, leaky=leaky)
        self.merge2 = ConvBN(out_ch, out_ch, leaky=leaky)

    def forward(self, feats):
        o1, o2, o3 = self.output1(feats[0]), self.output2(feats[1]), self.output3(feats[2])
        o2 = self.merge2(o2 + upsample_nearest_to(o3, o2.shape[2:]))
        o1 = self.merge1(o1 + upsample_nearest_to(o2, o1.shape[2:]))
        return o1, o2, o3


class SSH(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        leaky = 0.1 if out_ch <= 64 else 0.0
        self.conv3X3 = ConvBN(in_ch, out_ch // 2, relu=False)
        self.conv5X5_1 = ConvBN(in_ch, out_ch // 4, leaky=leaky)
        self.conv5X5_2 = ConvBN(out_ch // 4, out_ch // 4, relu=False)
        self.conv7X7_2 = ConvBN(out_ch // 4, out_ch // 4, leaky=leaky)
        self.conv7x7_3 = ConvBN(out_ch // 4, out_ch // 4, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5_1 = self.conv5X5_1(x)
        return F.relu(torch.cat(
            [self.conv3X3(x), self.conv5X5_2(c5_1), self.conv7x7_3(self.conv7X7_2(c5_1))],
            dim=1))


class Head(nn.Module):
    """1x1 conv head; rows (h, w, anchor) like the reference's permute."""

    def __init__(self, in_ch: int, anchors: int, width: int):
        super().__init__()
        self.width = width
        self.conv1x1 = nn.Conv2d(in_ch, anchors * width, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1x1(x).permute(0, 2, 3, 1)
        return out.reshape(out.shape[0], -1, self.width)


class RetinaFace(nn.Module):
    """Normalised BGR frames [B, H, W, 3] -> (loc [B, A, 4], conf [B, A, 2]
    softmaxed in f32, landms [B, A, 10])."""

    def __init__(self, num_anchors: int = 2):
        super().__init__()
        self.body = ResNet50Body()
        self.fpn = FPN((512, 1024, 2048), 256)
        self.ssh1 = SSH(256, 256)
        self.ssh2 = SSH(256, 256)
        self.ssh3 = SSH(256, 256)
        self.ClassHead = nn.ModuleList(Head(256, num_anchors, 2) for _ in range(3))
        self.BboxHead = nn.ModuleList(Head(256, num_anchors, 4) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(Head(256, num_anchors, 10) for _ in range(3))

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2).to(self.body.conv1.weight.dtype)
        fpn = self.fpn(self.body(x))
        feats = [self.ssh1(fpn[0]), self.ssh2(fpn[1]), self.ssh3(fpn[2])]
        loc = torch.cat([self.BboxHead[i](f) for i, f in enumerate(feats)], dim=1)
        conf = torch.cat([self.ClassHead[i](f) for i, f in enumerate(feats)], dim=1)
        landms = torch.cat([self.LandmarkHead[i](f) for i, f in enumerate(feats)], dim=1)
        return loc, torch.softmax(conf.float(), dim=-1), landms
