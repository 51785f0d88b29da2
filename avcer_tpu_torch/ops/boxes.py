"""RetinaFace anchors and box/landmark decoding (avcer_tpu/ops/boxes.py).

Anchors at strides 8/16/32 with min sizes [[16, 32], [64, 128], [256, 512]],
rows ordered per level, row-major over feature cells, then per min size: the
order the heads emit. Decoding uses variances (0.1, 0.2) in the JAX
package's operation order.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

MIN_SIZES: tuple[tuple[int, int], ...] = ((16, 32), (64, 128), (256, 512))
STEPS: tuple[int, int, int] = (8, 16, 32)
VARIANCES: tuple[float, float] = (0.1, 0.2)


@lru_cache(maxsize=32)
def prior_boxes(image_hw: tuple[int, int]) -> np.ndarray:
    """[A, 4] anchors as normalised (cx, cy, w, h), float32 (read-only: the
    array is shared by every caller)."""
    h, w = image_hw
    out = []
    for sizes, step in zip(MIN_SIZES, STEPS):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        jj, ii = np.meshgrid(np.arange(fw), np.arange(fh))
        cx = (jj + 0.5) * step / w
        cy = (ii + 0.5) * step / h
        level = np.empty((fh, fw, len(sizes), 4), dtype=np.float32)
        for s_idx, min_size in enumerate(sizes):
            level[..., s_idx, 0] = cx
            level[..., s_idx, 1] = cy
            level[..., s_idx, 2] = min_size / w
            level[..., s_idx, 3] = min_size / h
        out.append(level.reshape(-1, 4))
    priors = np.concatenate(out, axis=0)
    priors.setflags(write=False)
    return priors


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """[..., A, 4] regressions -> normalised (x1, y1, x2, y2)."""
    centers = priors[..., :2] + loc[..., :2] * VARIANCES[0] * priors[..., 2:]
    sizes = priors[..., 2:] * torch.exp(loc[..., 2:] * VARIANCES[1])
    tl = centers - sizes / 2
    return torch.cat([tl, tl + sizes], dim=-1)


def decode_landmarks(pre: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """[..., A, 10] regressions -> 5 normalised (x, y) points."""
    pts = pre.reshape(*pre.shape[:-1], 5, 2)
    out = priors[..., None, :2] + pts * VARIANCES[0] * priors[..., None, 2:]
    return out.reshape(*pre.shape[:-1], 10)
