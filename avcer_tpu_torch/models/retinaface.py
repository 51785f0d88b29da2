"""RetinaFace face detector (avcer_tpu/models/retinaface.py) with its two
backbones: the torchvision v1.5 ResNet50 body (FPN and SSH 256 wide, ReLU) or
the MobileNetV1-0.25 body (64 wide, leaky ReLU 0.1 inside the body, the FPN
and the SSH modules), then the 1x1 heads.

Parameter names follow the reference torch module (``TwinRetinaFace`` with
``TVStyleResNet50Body`` in tests/torch_twins.py; for mobilenet the reference's
``stage1..3`` Sequentials of ``conv_bn`` and ``conv_dw``), so a
``Resnet50_Final.pth`` or ``mobilenet0.25_Final.pth`` state dict loads
strictly. Public layout is the JAX package's: NHWC input,
``(loc [B, A, 4], conf [B, A, 2], landms [B, A, 10])`` with anchor rows in
(level, h, w, anchor) order, conf softmaxed in f32. Inside, convolutions run
NCHW in the weights' dtype.

The fused switches are the JAX package's, over the same state dict:
``fused_layer1``, ``fused_tails`` and ``fused_entries`` run the body's
bottleneck chains through ``ops.cuda.fused_resnet_kernel.fused_chain``;
``fused_ssh`` and ``fused_fpn`` run each scale's FPN, SSH module and heads
through ``ops.cuda.fused_ssh_kernel.fused_ssh_heads``, for either backbone
(at 64 channels with the kernel's leaky ReLU). The mobilenet body has no
bottleneck chains: the three chain switches are accepted and do nothing
there, as in the JAX package. Tensors keep torch's
NCHW shape between sections; a kernel section takes an NHWC-contiguous view
(one copy where the tensor comes from a cuDNN section, none between two
kernel sections) and hands back an NCHW-shaped view of its NHWC result, which
cuDNN reads as channels-last.

``quant`` is the JAX package's int8 variant over the same state dict: every
conv of the body's bottlenecks, of the FPN and of the SSH modules is a
``layers.QConv`` (calibrated static activation scales, per-channel weight
scales, int32 sums); the stem and the heads stay exact. In the mobilenet body
only the pointwise convs are quantised: the first conv (3 input channels) and
every depthwise conv stay in the compute dtype. With the fused
switches the int8 convs run inside the fused kernels' int8 mode, folded to
``(wq, mult, shift)`` with the activation scales in the kernels' order, and
their int8 weights packed once per fold for the kernels' product
(``pack_chain_q``).
Calibration forwards (``layers.calibrating``) and a model in ``training`` always
run the unfused modules.
The space-to-depth stem is not ported yet.

Every call of the two kernels goes through ``kernel``: by this module's
attribute, looked up at each call (callers may rebind these module
attributes), and through ``piecewise.call``, so that the detect stage's
piecewise graphs (``models.piecewise``) make each call eagerly between two
captured pieces.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from avcer_tpu_torch.models import piecewise
from avcer_tpu_torch.models.layers import (BatchNorm, FoldCache, QConv, compute_dtype, fold_bn,
                                           fold_bn_q)
# fused_chain and fused_ssh_heads are called by name (``kernel``)
from avcer_tpu_torch.ops.cuda.fused_resnet_kernel import fused_chain, pack_chain_q  # noqa: F401
from avcer_tpu_torch.ops.cuda.fused_ssh_kernel import activate, fused_ssh_heads  # noqa: F401


def kernel(name: str, *args, **kwargs):
    """``fused_chain`` or ``fused_ssh_heads`` of this module, called through
    ``piecewise.call``."""
    return piecewise.call(lambda: globals()[name], args, kwargs)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW-shaped -> NHWC contiguous (no copy if ``x`` is channels-last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def fold_pairs(pairs, dtype: torch.dtype) -> tuple[list[torch.Tensor], Optional[torch.Tensor]]:
    """(conv, BatchNorm) pairs -> (flat ``(w, inv, shift)`` per conv, act_s):
    the exact fold in ``dtype`` with ``act_s`` None, or for ``QConv``s the
    int8 fold with one activation scale per conv, in the order given."""
    if not isinstance(pairs[0][0], QConv):
        return [t for conv, bn in pairs for t in fold_bn(conv.weight, bn, dtype)], None
    got = [fold_bn_q(conv, bn) for conv, bn in pairs]
    return [t for triple, _ in got for t in triple], torch.stack([sx for _, sx in got])


def make_conv(inp: int, oup: int, k: int, stride: int, padding: int, quant: bool) -> nn.Module:
    """A bias-free conv: ``nn.Conv2d``, or its int8 stand-in."""
    if quant:
        return QConv(inp, oup, k, stride, padding, bias=False)
    return nn.Conv2d(inp, oup, k, stride, padding, bias=False)


class ConvBN(nn.Sequential):
    """Conv (no bias) -> BatchNorm -> optional (leaky) ReLU; state names
    ``0.weight`` and ``1.*`` like the reference's ``conv_bn`` Sequentials."""

    def __init__(self, inp: int, oup: int, k: int = 3, stride: int = 1,
                 leaky: float = 0.0, relu: bool = True, quant: bool = False):
        super().__init__(make_conv(inp, oup, k, stride, (k - 1) // 2, quant), BatchNorm(oup))
        self.act = relu
        self.leaky = leaky

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[1](self[0](x))
        # the leaky slope is rounded to the activation's dtype first, as the
        # JAX package and the fused kernel round it
        return activate(x, self.leaky) if self.act else x


class TVBottleneck(nn.Module):
    """torchvision Bottleneck: stride on the 3x3 conv (v1.5), BN eps 1e-5."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False,
                 quant: bool = False):
        super().__init__()
        self.conv1 = make_conv(in_ch, planes, 1, 1, 0, quant)
        self.bn1 = BatchNorm(planes)
        self.conv2 = make_conv(planes, planes, 3, stride, 1, quant)
        self.bn2 = BatchNorm(planes)
        self.conv3 = make_conv(planes, planes * 4, 1, 1, 0, quant)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (
            nn.Sequential(make_conv(in_ch, planes * 4, 1, stride, 0, quant),
                          BatchNorm(planes * 4))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idn = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + idn)

    def fold_pairs(self) -> list:
        """(conv, BatchNorm) of conv1, conv2, conv3 and the projection: the
        order of the fused kernel's weights and of its int8 scales."""
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        if self.downsample is not None:
            pairs.append((self.downsample[0], self.downsample[1]))
        return pairs

    def folded(self, dtype: torch.dtype) -> list[torch.Tensor]:
        """Flat ``(w, inv, shift)`` of conv1, conv2, conv3 and the projection."""
        return fold_pairs(self.fold_pairs(), dtype)[0]


def fused_section(cache: FoldCache, h: torch.Tensor, layer: nn.Sequential, li: int,
                  chunk: list[int], kinds: tuple[str, ...]) -> torch.Tensor:
    """Blocks ``chunk`` of ``layer`` as one ``fused_chain`` call on NCHW-shaped
    ``h``; the folded weights (and, in int8, the activation scales and the
    kernel's packed copy of the int8 weights) are made once per (chunk,
    dtype, device)."""
    conv1 = layer[chunk[0]].conv1
    dtype = compute_dtype(conv1)

    def fold():
        folded, act_s = fold_pairs([p for bi in chunk for p in layer[bi].fold_pairs()], dtype)
        return folded, act_s, None if act_s is None else pack_chain_q(folded)

    folded, act_s, packed = cache.folded((li, tuple(chunk), dtype, conv1.weight.device), fold)
    return kernel("fused_chain", nhwc(h.to(dtype)), folded, kinds, act_s=act_s,
                  packed=packed).permute(0, 3, 1, 2)


class ResNet50Body(FoldCache):
    """torchvision-resnet50 backbone emitting layer2/3/4 features.

    ``fused_layer1``: layer1 as one chain ("ds", "id", "id"). ``fused_tails``:
    the stride-1 tails of layers 2-3 in chunks of three, their stride-2 entry
    unfused. ``fused_entries`` (with ``fused_tails``): the entries fused too
    ("s2ds"), layer2 as one chain and layer3 as entry + 1, then chunks of
    three. layer4 is never fused."""

    def __init__(self, fused_layer1: bool = False, fused_tails: bool = False,
                 fused_entries: bool = False, quant: bool = False):
        super().__init__()
        self.fused_layer1 = fused_layer1
        self.fused_tails = fused_tails
        self.fused_entries = fused_entries
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for li, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                layer.append(TVBottleneck(in_ch, planes, s,
                                          bi == 0 and (s != 1 or in_ch != planes * 4), quant))
                in_ch = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # the stem stays exact in the int8 variant: 3 input channels
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        outs = []
        fused = not (self.calibrating or self.training)
        for li in range(4):
            layer = getattr(self, f"layer{li + 1}")
            blocks = len(layer)
            if li == 0 and self.fused_layer1 and fused:
                h = fused_section(self, h, layer, li, list(range(blocks)), ("ds", "id", "id"))
            elif li in (1, 2) and self.fused_tails and fused:
                if self.fused_entries:
                    # layer3 takes one "id" with its entry, then chunks of three
                    first = blocks if li == 1 else 2
                    chunks, tail = [list(range(first))], list(range(first, blocks))
                else:
                    h = layer[0](h)  # the stride-2 entry stays a cuDNN section
                    chunks, tail = [], list(range(1, blocks))
                while tail:
                    chunks.append(tail[:3])
                    tail = tail[3:]
                for chunk in chunks:
                    kinds = tuple("s2ds" if bi == 0 else "id" for bi in chunk)
                    h = fused_section(self, h, layer, li, chunk, kinds)
            else:
                h = layer(h)
            if li >= 1:
                outs.append(h)
        return tuple(outs)


class LeakyReLU(nn.Module):
    """``activate`` as a module (``nn.LeakyReLU`` multiplies by the f32 slope)."""

    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activate(x, self.slope)


class ConvDW(nn.Sequential):
    """MobileNetV1 block: depthwise 3x3 -> BatchNorm -> leaky 0.1 -> pointwise
    1x1 -> BatchNorm -> leaky 0.1, with the state names of the reference's
    ``conv_dw`` Sequential (``0``, ``1``, ``3``, ``4``). The depthwise half is
    a grouped ``F.conv2d`` (a library call, as in the JAX package it is an XLA
    op) and is never quantised."""

    def __init__(self, inp: int, oup: int, stride: int, quant: bool = False):
        super().__init__(
            nn.Conv2d(inp, inp, 3, stride, 1, groups=inp, bias=False), BatchNorm(inp),
            LeakyReLU(0.1),
            make_conv(inp, oup, 1, 1, 0, quant), BatchNorm(oup), LeakyReLU(0.1))


class MobileNetV1Body(nn.Module):
    """MobileNetV1-0.25 backbone emitting stage1/2/3 features (64, 128 and
    256 channels at strides 8, 16 and 32)."""

    def __init__(self, quant: bool = False):
        super().__init__()
        # the first conv stays exact in the int8 variant: 3 input channels
        self.stage1 = nn.Sequential(
            ConvBN(3, 8, stride=2, leaky=0.1),
            *[ConvDW(i, o, s, quant)
              for i, o, s in ((8, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1))])
        self.stage2 = nn.Sequential(
            ConvDW(64, 128, 2, quant), *[ConvDW(128, 128, 1, quant) for _ in range(5)])
        self.stage3 = nn.Sequential(ConvDW(128, 256, 2, quant), ConvDW(256, 256, 1, quant))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        s1 = self.stage1(x)
        s2 = self.stage2(s1)
        return s1, s2, self.stage3(s2)


def upsample_nearest_to(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """torch nearest to an exact size: source index floor(i * in / out)."""
    h, w = x.shape[2], x.shape[3]
    ri = (torch.arange(hw[0], device=x.device) * h) // hw[0]
    ci = (torch.arange(hw[1], device=x.device) * w) // hw[1]
    return x[:, :, ri][:, :, :, ci]


class FPN(nn.Module):
    def __init__(self, in_list: tuple[int, int, int], out_ch: int, quant: bool = False):
        super().__init__()
        leaky = 0.1 if out_ch <= 64 else 0.0
        self.output1 = ConvBN(in_list[0], out_ch, k=1, leaky=leaky, quant=quant)
        self.output2 = ConvBN(in_list[1], out_ch, k=1, leaky=leaky, quant=quant)
        self.output3 = ConvBN(in_list[2], out_ch, k=1, leaky=leaky, quant=quant)
        self.merge1 = ConvBN(out_ch, out_ch, leaky=leaky, quant=quant)
        self.merge2 = ConvBN(out_ch, out_ch, leaky=leaky, quant=quant)

    def forward(self, feats):
        o1, o2, o3 = self.output1(feats[0]), self.output2(feats[1]), self.output3(feats[2])
        o2 = self.merge2(o2 + upsample_nearest_to(o3, o2.shape[2:]))
        o1 = self.merge1(o1 + upsample_nearest_to(o2, o1.shape[2:]))
        return o1, o2, o3


class SSH(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, quant: bool = False):
        super().__init__()
        leaky = 0.1 if out_ch <= 64 else 0.0
        self.conv3X3 = ConvBN(in_ch, out_ch // 2, relu=False, quant=quant)
        self.conv5X5_1 = ConvBN(in_ch, out_ch // 4, leaky=leaky, quant=quant)
        self.conv5X5_2 = ConvBN(out_ch // 4, out_ch // 4, relu=False, quant=quant)
        self.conv7X7_2 = ConvBN(out_ch // 4, out_ch // 4, leaky=leaky, quant=quant)
        self.conv7x7_3 = ConvBN(out_ch // 4, out_ch // 4, relu=False, quant=quant)

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


class RetinaFace(FoldCache):
    """Normalised BGR frames [B, H, W, 3] -> (loc [B, A, 4], conf [B, A, 2]
    softmaxed in f32, landms [B, A, 10]). ``raw_conf``: conf as the heads'
    logits (the JAX package's option, for the multibox loss in training).

    ``fused_ssh``: each scale's SSH module and heads as one kernel call after
    the unfused FPN. With ``fused_fpn`` too, the FPN goes into the same calls:
    scales 3, 2, 1 in that order, scale 3 emitting its lateral and scale 2 its
    merged feature for the next finer scale's top-down add."""

    def __init__(self, num_anchors: int = 2, fused_layer1: bool = False,
                 fused_tails: bool = False, fused_entries: bool = False,
                 fused_ssh: bool = False, fused_fpn: bool = False, quant: bool = False,
                 backbone: str = "resnet50", raw_conf: bool = False):
        super().__init__()
        self.backbone = backbone
        self.raw_conf = raw_conf
        self.fused_ssh = fused_ssh
        self.fused_fpn = fused_fpn
        self.quant = quant
        if backbone == "resnet50":
            self.body = ResNet50Body(fused_layer1, fused_tails, fused_entries, quant)
            taps, c = (512, 1024, 2048), 256
        elif backbone == "mobilenet0.25":
            self.body = MobileNetV1Body(quant)  # no bottleneck chains to fuse
            taps, c = (64, 128, 256), 64
        else:
            raise ValueError(backbone)
        self.out_ch = c
        self.fpn = FPN(taps, c, quant)
        self.ssh1 = SSH(c, c, quant)
        self.ssh2 = SSH(c, c, quant)
        self.ssh3 = SSH(c, c, quant)
        self.ClassHead = nn.ModuleList(Head(c, num_anchors, 2) for _ in range(3))
        self.BboxHead = nn.ModuleList(Head(c, num_anchors, 4) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(Head(c, num_anchors, 10) for _ in range(3))

    def _scale_folded(self, i: int, dtype: torch.dtype):
        """(5 SSH convs, 3 heads, lateral, merge or None, scales, packed) of
        scale ``i``. ``scales`` and ``packed`` are None for the exact model; in
        int8 ``scales`` holds the activation scales of (lateral, merge or None,
        the five SSH convs) and ``packed`` the kernel's copy of their int8
        weights (``pack_chain_q`` of the lateral, the merge and the SSH folds,
        in that order)."""
        ssh = getattr(self, f"ssh{i + 1}")
        convs, ssh_sx = fold_pairs([tuple(getattr(ssh, name)) for name in (
            "conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2", "conv7x7_3")], dtype)
        heads = tuple(t for head in (self.BboxHead[i], self.ClassHead[i], self.LandmarkHead[i])
                      for t in (head.conv1x1.weight[:, :, 0, 0].t().to(dtype).contiguous(),
                                head.conv1x1.bias.to(dtype)))
        lat, lat_sx = fold_pairs([tuple(getattr(self.fpn, f"output{i + 1}"))], dtype)
        merge, merge_sx = (fold_pairs([tuple(getattr(self.fpn, f"merge{i + 1}"))], dtype)
                           if i < 2 else (None, None))
        scales = packed = None
        if ssh_sx is not None:
            scales = (lat_sx, merge_sx, ssh_sx)
            packed = pack_chain_q(list(lat) + list(merge or ()) + list(convs))
        return (tuple(convs), heads, tuple(lat), None if merge is None else tuple(merge), scales,
                packed)

    def _fused_heads(self, feats, dtype: torch.dtype):
        """``feats`` NCHW-shaped: the body's (with ``fused_fpn``) or the
        FPN's. Rows stay (h, w, anchor): the kernel writes NHWC. The folds
        (and, in int8, the packed weights) are made once per (scale, dtype,
        device)."""
        leaky = 0.1 if self.out_ch <= 64 else 0.0  # as FPN and SSH choose theirs
        per_scale: list = [None, None, None]
        feat_prev = None
        for i in (2, 1, 0):
            w = self.BboxHead[0].conv1x1.weight
            convs, heads, lat, merge, scales, packed = self.folded(
                ("scale", i, w.dtype, w.device), lambda: self._scale_folded(i, dtype))
            x = nhwc(feats[i].to(dtype))
            if self.fused_fpn:
                up = None
                if feat_prev is not None:
                    up = nhwc(upsample_nearest_to(feat_prev.permute(0, 3, 1, 2), x.shape[1:3]))
                # the kernel's order of scales: lateral, merge, the SSH convs
                act_s = None if scales is None else torch.cat(
                    [sx for sx in scales if sx is not None])
                res = kernel("fused_ssh_heads", x, convs, heads, leaky, fpn_lat=lat,
                             fpn_merge=merge, up=up, emit_feature=i > 0, act_s=act_s,
                             packed=packed)
                if i > 0:
                    feat_prev = res[3]
            else:
                res = kernel("fused_ssh_heads", x, convs, heads, leaky,
                             act_s=None if scales is None else scales[2],
                             packed=None if packed is None else packed[-5:])
            b = x.shape[0]
            per_scale[i] = (res[0].reshape(b, -1, 4), res[1].reshape(b, -1, 2),
                            res[2].reshape(b, -1, 10))
        loc, conf, landms = (torch.cat([o[k] for o in per_scale], dim=1) for k in range(3))
        return loc, self._conf(conf), landms

    def _conf(self, conf: torch.Tensor) -> torch.Tensor:
        return conf if self.raw_conf else torch.softmax(conf.float(), dim=-1)

    def forward(self, x: torch.Tensor):
        dtype = self.BboxHead[0].conv1x1.weight.dtype
        x = x.permute(0, 3, 1, 2).to(dtype)
        feats = self.body(x)
        if self.fused_ssh and not (self.calibrating or self.training):
            return self._fused_heads(feats if self.fused_fpn else self.fpn(feats), dtype)
        fpn = self.fpn(feats)
        feats = [self.ssh1(fpn[0]), self.ssh2(fpn[1]), self.ssh3(fpn[2])]
        loc = torch.cat([self.BboxHead[i](f) for i, f in enumerate(feats)], dim=1)
        conf = torch.cat([self.ClassHead[i](f) for i, f in enumerate(feats)], dim=1)
        landms = torch.cat([self.LandmarkHead[i](f) for i, f in enumerate(feats)], dim=1)
        return loc, self._conf(conf), landms
