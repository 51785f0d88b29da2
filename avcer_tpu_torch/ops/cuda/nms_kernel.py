"""Wrapper of the CUDA greedy-NMS kernel (``csrc/nms.cu``), the counterpart of
avcer_tpu/ops/pallas/nms_kernel.py ``pallas_nms_mask``.

Dispatch rule, with no fallback: a CPU tensor goes to the plain version
(``avcer_tpu_torch.ops.nms.nms_mask``, re-exported here as ``nms_mask_plain``);
a CUDA tensor launches the kernel or raises. The port has no ``nms_impl``
option: on the card the kernel is the only implementation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from avcer_tpu_torch import _build
from avcer_tpu_torch.ops.nms import nms_mask as nms_mask_plain

MAX_K = 1024


@functools.cache
def _entry():
    """The C entry point ``avcer_nms_mask``, typed once (the library is
    built at first use)."""
    fn = _build.library("nms").avcer_nms_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_mask(
    boxes: torch.Tensor,  # [B, K, 4] f32 xyxy, rows sorted by descending score
    valid: torch.Tensor,  # [B, K] bool
    iou_thresh: float = 0.4,
    plus_one: bool = True,
) -> torch.Tensor:
    """Keep mask [B, K] bool: legacy +1 IoU (``plus_one=False``: S3FD's IoU,
    no +1), strict ``>`` suppresses, greedy in row order, ``& valid``.
    ``nms_mask.launches`` counts kernel launches, ``launches_by_mode`` them
    by ``plus_one``."""
    if boxes.device.type == "cpu":
        return nms_mask_plain(boxes, valid, iou_thresh, plus_one)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_mask: unsupported device {boxes.device}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(
            f"nms_mask: boxes must be [B, K, 4] float32, got "
            f"{tuple(boxes.shape)} {boxes.dtype}")
    b, k, _ = boxes.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k):
        raise ValueError(
            f"nms_mask: valid must be [{b}, {k}] bool, got "
            f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError("nms_mask: boxes and valid are on different devices")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_mask: boxes and valid must be contiguous")
    if k > MAX_K:
        raise ValueError(f"nms_mask: K = {k} > {MAX_K} (the suppression bits of a "
                         "frame fill one block's shared memory)")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    fn = _entry()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    args = (boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, iou_thresh,
            1.0 if plus_one else 0.0, stream)
    if boxes.device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:  # the launch goes to the current device: make it the boxes' own
        with torch.cuda.device(boxes.device):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {rc}")
    nms_mask.launches += 1
    nms_mask.launches_by_mode[bool(plus_one)] += 1
    return keep


nms_mask.launches = 0
nms_mask.launches_by_mode = {True: 0, False: 0}
