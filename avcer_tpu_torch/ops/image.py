"""Image ops (avcer_tpu/ops/image.py): detector and emotion-CNN input
normalisation, PIL-nearest indices, the device face crop, the reference's
box clamp rule and the letterbox geometry. Frames are NHWC uint8 BGR.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from avcer_tpu_torch.core import registry


def nearest_indices_np(out_size: int, in_size: int) -> np.ndarray:
    """PIL-NEAREST source index per output position (int32), bit-exact:
    Pillow walks the source coordinate incrementally in float64
    (``x = scale/2; x += scale``) and floors it."""
    scale = in_size / out_size
    idx = np.empty(out_size, np.int32)
    x = scale / 2.0
    for i in range(out_size):
        idx[i] = int(np.floor(x))
        x += scale
    return np.clip(idx, 0, in_size - 1)


def crop_and_resize(
    frames: torch.Tensor,  # [N, H, W, C] uint8, on the device
    idx: torch.Tensor,  # [B] int frame indices
    boxes: torch.Tensor,  # [B, 4] int (x1, y1, x2, y2), exclusive right/bottom
    out_size: int = registry.FACE_INPUT_SIZE,
) -> torch.Tensor:
    """Crop + nearest resize as one gather, with the index contract of
    ``crop_and_resize_onehot``: row i of a crop reads source row
    ``clip(y1 + ((2i+1) * max(y2-y1, 1)) // (2*out), 0, H-1)``, columns
    likewise. A gather moves the same uint8 values the TPU's one-hot
    matmuls select, so the result is identical. -> [B, out, out, C]."""
    h, w = frames.shape[1], frames.shape[2]
    boxes = boxes.long()
    x1, y1, x2, y2 = boxes.unbind(-1)
    bh = (y2 - y1).clamp_min(1)
    bw = (x2 - x1).clamp_min(1)
    two_i_plus_1 = 2 * torch.arange(out_size, device=frames.device) + 1
    rows = (y1[:, None] + (two_i_plus_1[None, :] * bh[:, None]) // (2 * out_size)).clamp(0, h - 1)
    cols = (x1[:, None] + (two_i_plus_1[None, :] * bw[:, None]) // (2 * out_size)).clamp(0, w - 1)
    return frames[idx.long()[:, None, None], rows[:, :, None], cols[:, None, :]]


def clamp_boxes(boxes: np.ndarray, width: int, height: int) -> np.ndarray:
    """The reference clamp: int cast (truncation), start >= 0, end <= size-1
    (get_face_images.py:53-56)."""
    b = boxes[:, :4].astype(np.int32).copy()
    b[:, 0] = np.maximum(0, b[:, 0])
    b[:, 1] = np.maximum(0, b[:, 1])
    b[:, 2] = np.minimum(width - 1, b[:, 2])
    b[:, 3] = np.minimum(height - 1, b[:, 3])
    return b


def clamp_boxes_valid(
    boxes: np.ndarray, width: int, height: int
) -> tuple[np.ndarray, np.ndarray]:
    """``clamp_boxes`` plus the degenerate-box test ``x2 > x1 and y2 > y1``
    that decides whether a detection yields a crop. boxes: float [N, >=4].
    Returns (int32 [N, 4], valid bool [N])."""
    b = clamp_boxes(np.atleast_2d(np.asarray(boxes)), width, height)
    return b, (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])


def vggface_normalize(crops_bgr: torch.Tensor) -> torch.Tensor:
    """Emotion-CNN input: f32 BGR minus the VGGFace2 means."""
    mean = torch.tensor(registry.VGGFACE2_BGR_MEAN, dtype=torch.float32,
                        device=crops_bgr.device)
    return crops_bgr.float() - mean


def retinaface_normalize(frames_bgr: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Detector input: BGR minus (104, 117, 123); exact in bf16 too, since
    every value in [-123, 151] is an integer bf16 holds."""
    mean = torch.tensor(registry.RETINAFACE_BGR_MEAN, dtype=dtype,
                        device=frames_bgr.device)
    return frames_bgr.to(dtype) - mean


def letterbox_params(h: int, w: int, long_side: int) -> tuple[int, int, float]:
    """(new_h, new_w, scale) so that max(new_h, new_w) == long_side with the
    aspect kept; dims rounded up to even."""
    scale = long_side / max(h, w)
    nh = max(2, round(h * scale))
    nw = max(2, round(w * scale))
    return nh + (nh % 2), nw + (nw % 2), scale


def resize_bilinear_uint8(frames: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, nh, nw, 3] uint8 by bilinear interpolation
    (half-pixel centres, no antialias), rounded: the device stand-in for
    ``cv2.resize(INTER_LINEAR)``, within 1 LSB of it."""
    x = frames.permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    return y.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
