"""Wrapper of the CUDA I420 -> BGR kernel (``csrc/image.cu``), the device half
of the detect stage's I420 wire format. It replaces no Pallas kernel: the JAX
package computes avcer_tpu/ops/image.py ``i420_to_bgr_device`` in XLA.

Dispatch rule, with no fallback: a CPU tensor goes to the plain version
(``avcer_tpu_torch.ops.image.i420_to_bgr_plain``, re-exported here); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from avcer_tpu_torch import _build
from avcer_tpu_torch.ops.image import i420_to_bgr_plain
from avcer_tpu_torch.utils import trace


@functools.cache
def _entry():
    """The C entry point ``avcer_i420_to_bgr``, typed once (the library is
    built at first use)."""
    fn = _build.library("image").avcer_i420_to_bgr
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def i420_to_bgr(wire: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*3//2, W] uint8 I420 -> [B, H, W, 3] uint8 BGR, equal bit for bit
    to ``i420_to_bgr_plain``. ``i420_to_bgr.launches`` counts kernel
    launches."""
    if wire.device.type == "cpu":
        return i420_to_bgr_plain(wire, h, w)
    if wire.device.type != "cuda":
        raise ValueError(f"i420_to_bgr: unsupported device {wire.device}")
    if (wire.dtype != torch.uint8 or wire.dim() != 3
            or tuple(wire.shape[1:]) != (h * 3 // 2, w)):
        raise ValueError(f"i420_to_bgr: wire must be [B, {h * 3 // 2}, {w}] uint8, got "
                         f"{tuple(wire.shape)} {wire.dtype}")
    if h <= 0 or w <= 0 or h % 2 or w % 2:
        raise ValueError(f"i420_to_bgr: H = {h} and W = {w} must be even and positive "
                         "(one chroma sample a 2 x 2 quad)")
    if not wire.is_contiguous():
        raise ValueError("i420_to_bgr: wire must be contiguous")
    b = wire.shape[0]
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=wire.device)
    fn = _entry()
    with torch.cuda.device(wire.device):
        rc = fn(wire.data_ptr(), out.data_ptr(), b, h, w,
                torch.cuda.current_stream(wire.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"i420_to_bgr kernel launch failed: CUDA error {rc}")
    trace.launched(i420_to_bgr)
    return out


i420_to_bgr.launches = 0
