"""Image ops (avcer_tpu/ops/image.py): detector and emotion-CNN input
normalisation, PIL-nearest indices, the device face crop, the reference's
box clamp rule and the letterbox geometry. Frames are NHWC uint8 BGR.
"""

from __future__ import annotations

from typing import Optional

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


def retinaface_normalize(frames_bgr: torch.Tensor, dtype: torch.dtype = torch.float32,
                         mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Detector input: BGR minus (104, 117, 123); exact in bf16 too, since
    every value in [-123, 151] is an integer bf16 holds. ``mean``: those
    three values in ``dtype`` on the frames' device, kept by the caller
    (made here otherwise: a host-to-device copy that waits for the
    stream)."""
    if mean is None:
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


# The I420 wire format (avcer_tpu/ops/image.py:193-236): the host letterboxes
# and converts each frame to I420 with cv2 (BT.601 studio swing, top-left
# chroma subsample), the upload carries 1.5 bytes a pixel instead of 3, and
# the device rebuilds BGR (within 1 of cv2.COLOR_YUV2BGR_I420). On the card
# the rebuild is the CUDA kernel ``ops.cuda.image_kernel.i420_to_bgr``.


def bgr_batch_to_i420(frames: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """[B, H, W, 3] uint8 BGR -> [B, H*3//2, W] uint8 I420 (host, cv2),
    written into ``out`` where given."""
    import cv2

    b, h, w = frames.shape[:3]
    if out is None:
        out = np.empty((b, h * 3 // 2, w), np.uint8)
    for i in range(b):
        out[i] = cv2.cvtColor(frames[i], cv2.COLOR_BGR2YUV_I420)
    return out


def i420_to_bgr_plain(wire: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*3//2, W] uint8 I420 -> [B, H, W, 3] uint8 BGR, the JAX formula in
    its order: ``1.164 (y - 16)``, each chroma value repeated over its 2 x 2
    quad minus 128, the three sums, round half to even, clamp, cast. The
    chroma planes are packed flat after the Y plane, and the U plane ends
    mid-row where (H/2)(W/2) is not a multiple of W, so they are read flat."""
    xf = wire.float()
    b = wire.shape[0]
    y = xf[:, :h, :]
    qh, qw = h // 2, w // 2
    chroma = xf[:, h:, :].reshape(b, -1)
    qsize = qh * qw
    u = chroma[:, :qsize].reshape(b, qh, qw)
    v = chroma[:, qsize:2 * qsize].reshape(b, qh, qw)
    uf = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    vf = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    yb = 1.164 * (y - 16.0)
    bl = yb + 2.018 * uf
    g = yb - 0.391 * uf - 0.813 * vf
    r = yb + 1.596 * vf
    bgr = torch.stack([bl, g, r], dim=-1)
    return torch.round(bgr).clamp(0.0, 255.0).to(torch.uint8)
