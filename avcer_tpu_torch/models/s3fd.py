"""S3FD face detector (avcer_tpu/models/s3fd.py), the reference's alternative
detector (ibug face_detection s3fd_net.py, s3fd_predictor.py, utils.py):

- VGG16 trunk with the dilated fc6 / fc7 convs, ceil-mode pool3, L2Norm on
  conv3_3 / 4_3 / 5_3 with scales 10 / 8 / 5;
- extras conv6 / 7 (stride 2) for the last two scales;
- six one-anchor multibox heads; the first confidence head's max-out
  background: the max of channels 0..2 against channel 3;
- priors: one anchor a cell, steps 4..128, sizes 16..512.

Parameter names are the reference state dict's, as the JAX package's
``convert_s3fd`` reads them: ``vgg.N`` at the torch ModuleList indices of
the convs, fc6 and fc7 at ``vgg.30`` and ``vgg.32``; ``L2Norm3_3``,
``L2Norm4_3``, ``L2Norm5_3``; ``extras.N``, ``loc.N``, ``conf.N``.

The module is NCHW inside and takes [B, H, W, 3] (RGB minus (123, 117, 104))
like the port's RetinaFace. Convolutions run in the compute dtype of their
weights (``layers.cast_compute``); L2Norm and the softmax in f32.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

S3FD_STEPS = (4, 8, 16, 32, 64, 128)
S3FD_SIZES = (16, 32, 64, 128, 256, 512)
#: (torch index, in channels, out channels) of the trunk's 3x3 convs; fc6
#: (dilation 6) and fc7 (1x1) follow
VGG_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
             (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512),
             (24, 512, 512), (26, 512, 512), (28, 512, 512))
#: the convs after which the trunk pools (pool3, after conv 14, in ceil mode)
POOL_AFTER = {2: False, 7: False, 14: True, 21: False, 28: False}
SOURCE_CHANNELS = (256, 512, 512, 1024, 512, 256)
L2NORMS = (("L2Norm3_3", 14, 256, 10.0), ("L2Norm4_3", 21, 512, 8.0),
           ("L2Norm5_3", 28, 512, 5.0))


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learned per-channel scale, in f32
    (``+1e-10`` outside the square root), cast back to the input's dtype."""

    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf.square().sum(dim=1, keepdim=True).sqrt() + 1e-10
        return (self.weight[None, :, None, None] * (xf / norm)).to(x.dtype)


class S3FDNet(nn.Module):
    """[B, H, W, 3] f32 RGB minus (123, 117, 104) -> (loc [B, A, 4],
    conf [B, A, 2] softmaxed in f32), anchor rows level by level, row-major
    over each level's cells (one anchor a cell)."""

    def __init__(self):
        super().__init__()
        vgg = {str(i): nn.Conv2d(cin, cout, 3, padding=1) for i, cin, cout in VGG_CONVS}
        vgg["30"] = nn.Conv2d(512, 1024, 3, padding=6, dilation=6)  # fc6
        vgg["32"] = nn.Conv2d(1024, 1024, 1)  # fc7
        self.vgg = nn.ModuleDict(vgg)
        for name, _, ch, scale in L2NORMS:
            setattr(self, name, L2Norm(ch, scale))
        self.extras = nn.ModuleList([
            nn.Conv2d(1024, 256, 1), nn.Conv2d(256, 512, 3, stride=2, padding=1),
            nn.Conv2d(512, 128, 1), nn.Conv2d(128, 256, 3, stride=2, padding=1)])
        self.loc = nn.ModuleList([nn.Conv2d(c, 4, 3, padding=1) for c in SOURCE_CHANNELS])
        self.conf = nn.ModuleList([nn.Conv2d(c, 4 if i == 0 else 2, 3, padding=1)
                                   for i, c in enumerate(SOURCE_CHANNELS)])

    def reset_l2norm_scales(self) -> None:
        """The L2Norm weights at their initial scales (10, 8, 5), as the JAX
        package initialises them; a seeded init sets every norm weight to 1."""
        with torch.no_grad():
            for name, _, _, scale in L2NORMS:
                getattr(self, name).weight.fill_(scale)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dtype = self.vgg["0"].weight.dtype
        h = x.permute(0, 3, 1, 2).to(dtype)
        norms = {at: getattr(self, name) for name, at, _, _ in L2NORMS}
        sources = []
        for i, _, _ in VGG_CONVS:
            h = F.relu(self.vgg[str(i)](h))
            if i in norms:
                sources.append(norms[i](h))
            if i in POOL_AFTER:
                h = F.max_pool2d(h, 2, 2, ceil_mode=POOL_AFTER[i])
        h = F.relu(self.vgg["32"](F.relu(self.vgg["30"](h))))
        sources.append(h)
        for i in (0, 2):
            h = F.relu(self.extras[i + 1](F.relu(self.extras[i](h))))
            sources.append(h)

        locs, confs = [], []
        for i, src in enumerate(sources):
            # NHWC before the reshape: rows run row-major over the cells
            loc = self.loc[i](src).permute(0, 2, 3, 1)
            cf = self.conf[i](src).permute(0, 2, 3, 1)
            if i == 0:  # max-out background (s3fd_net.py:146-151)
                cf = torch.cat([cf[..., 0:3].amax(dim=-1, keepdim=True), cf[..., 3:]], dim=-1)
            locs.append(loc.reshape(loc.shape[0], -1, 4))
            confs.append(cf.reshape(cf.shape[0], -1, 2))
        loc = torch.cat(locs, dim=1)
        conf = torch.softmax(torch.cat(confs, dim=1).float(), dim=-1)
        return loc, conf


@lru_cache(maxsize=16)
def s3fd_priors(image_hw: tuple[int, int]) -> np.ndarray:
    """[A, 4] normalised (cx, cy, w, h) float32 (read-only: shared by every
    caller); the feature-map sizes follow the trunk's arithmetic (pool3 in
    ceil mode, the stride-2 extras with padding 1)."""
    h, w = image_hw
    fh, fw = h // 2 // 2, w // 2 // 2  # stride 4: conv3_3, after two pools
    sizes = [(fh, fw)]
    fh, fw = math.ceil(fh / 2), math.ceil(fw / 2)  # stride 8: ceil pool3
    sizes.append((fh, fw))
    for _ in range(2):  # strides 16, 32
        fh, fw = fh // 2, fw // 2
        sizes.append((fh, fw))
    for _ in range(2):  # strides 64, 128: the stride-2 extras
        fh, fw = (fh + 1) // 2, (fw + 1) // 2
        sizes.append((fh, fw))
    out = []
    for k, (feath, featw) in enumerate(sizes):
        jj, ii = np.meshgrid(np.arange(featw), np.arange(feath))
        cx = (jj + 0.5) * S3FD_STEPS[k] / w
        cy = (ii + 0.5) * S3FD_STEPS[k] / h
        level = np.stack([cx, cy, np.full_like(cx, S3FD_SIZES[k] / w),
                          np.full_like(cy, S3FD_SIZES[k] / h)], axis=-1).reshape(-1, 4)
        out.append(level.astype(np.float32))
    priors = np.concatenate(out, axis=0)
    priors.setflags(write=False)
    return priors
