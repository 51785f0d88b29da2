"""Face detection stage (avcer_tpu/pipeline/detect.py): letterbox ->
normalise -> RetinaFace -> decode -> top-64 candidates -> greedy NMS, on the
device and batched over frames. Only the tracker stays on the host.

The letterbox runs on the device (bilinear, half-pixel centres, rounded to
uint8), the stand-in for the JAX package's host ``cv2.resize(INTER_LINEAR)``
on a card with no OpenCV; it is within 1 LSB of cv2. Greedy NMS on the card
is the CUDA kernel (``ops.cuda.nms_kernel``). The detector's fused switches
(``DetectorConfig.fused_*``) are the model's: ``pipeline.builder`` hands them
to ``RetinaFace``, and the stage runs whichever model it is given: the r50 or
the mobilenet0.25 detector. ``DetectorConfig.stride`` runs the network on
every stride-th frame of a batch; the runner interpolates the boxes between.

int8 (``DetectorConfig.quant == "int8"``): the model's static activation
scales are seeded at build on two noise frames, refined once per process on
the first real batch's first two frames, and watched every ``RECALIB_EVERY``
batches (scales only grow; growth above 5 % is logged). Every calibration
forward runs the model's unfused int8 modules (``layers.calibrating``), also
when the stage serves through the fused kernels.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from avcer_tpu_torch.core.config import DetectorConfig
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.ops import boxes as box_ops
from avcer_tpu_torch.ops import nms as nms_ops
from avcer_tpu_torch.ops.cuda.nms_kernel import nms_mask
from avcer_tpu_torch.ops.image import (letterbox_params, resize_bilinear_uint8,
                                       retinaface_normalize)


log = logging.getLogger("avcer_tpu_torch")


@dataclass
class Detections:
    """Fixed-shape per-batch detections (native-resolution pixel coords)."""

    boxes: np.ndarray  # [B, K, 4] float32 xyxy
    scores: np.ndarray  # [B, K]
    keep: np.ndarray  # [B, K] bool
    landmarks: np.ndarray  # [B, K, 10]


class DetectStage:
    #: int8 drift watch: batches between sampled re-calibration forwards
    RECALIB_EVERY = 64
    #: the anchors of a bucket (h, w): [A, 4] normalised (cx, cy, w, h)
    prior_boxes = staticmethod(box_ops.prior_boxes)

    def __init__(self, cfg: DetectorConfig, model: torch.nn.Module,
                 device: torch.device | str = "cuda"):
        if cfg.transfer_format != "bgr":
            raise ValueError(
                f"transfer_format={cfg.transfer_format!r}: the I420 wire format "
                "is not ported (ROADMAP queue 1, 'Not ported': I420 wire "
                "format); use transfer_format='bgr'")
        if cfg.stride > 1 and cfg.batch_size % cfg.stride:
            raise ValueError(
                f"detector stride {cfg.stride} must divide batch_size {cfg.batch_size} "
                "(keeps the detection cadence uniform across fixed-shape batches)")
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant={cfg.quant!r}: only 'none' and 'int8' exist")
        if cfg.backbone != getattr(model, "backbone", cfg.backbone):
            raise ValueError(f"backbone={cfg.backbone!r} does not fit the model it was given")
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self._priors: dict[tuple[int, int], torch.Tensor] = {}
        self.quant = cfg.quant == "int8"
        if self.quant != bool(getattr(model, "quant", False)):
            raise ValueError(f"quant={cfg.quant!r} does not fit the model it was given")
        self._real_calibrated = False
        self._calib_lock = threading.Lock()
        self._batches_seen = 0
        #: calibration forwards made so far (seed, refinement, drift watch)
        self.calibration_forwards = 0
        if self.quant:
            # static scales: a dynamic scale costs every conv a reduction over
            # its whole input. Noise frames bound the first layers' ranges
            # until the first real batch refines them.
            self.calibrate(np.random.default_rng(0).integers(0, 255, (2, 160, 160, 3), np.uint8))

    @torch.inference_mode()
    def _calibrate_device(self, frames: torch.Tensor) -> None:
        with layers.calibrating(self.model):
            self.model(retinaface_normalize(frames))
        self.calibration_forwards += 1

    def calibrate(self, frames: np.ndarray) -> None:
        """Take the running max-abs of every int8 conv's input over ``frames``
        ([N, H, W, 3] uint8 BGR) into the model's activation scales. One
        unfused forward; scales only grow, so calling again is cumulative."""
        self._calibrate_device(torch.from_numpy(np.ascontiguousarray(frames)).to(self.device))

    def merge_act_scales(self, scales: Mapping[str, torch.Tensor]) -> None:
        """Adopt calibration scales made elsewhere: the elementwise running
        max with the model's own. Raises on a structure mismatch."""
        cur = layers.act_scales(self.model)
        if not cur:
            return
        layers.load_act_scales(self.model, layers.merge_act_scales_trees(cur, scales))
        self._real_calibrated = True

    def _watch_calibration(self, frames_dev: torch.Tensor) -> None:
        """Before a batch is served in int8: refine the noise-seeded scales on
        the first real batch's first two frames (once per process, under the
        lock), then re-run that forward every ``RECALIB_EVERY`` batches and
        warn when a scale grew by more than 5 %: a quiet first clip would
        leave later, louder clips clipped."""
        if not self._real_calibrated:
            with self._calib_lock:
                if not self._real_calibrated:
                    self._calibrate_device(frames_dev[:2])
                    self._real_calibrated = True
            return
        with self._calib_lock:
            self._batches_seen += 1
            if self._batches_seen % self.RECALIB_EVERY:
                return
            old = layers.act_scales(self.model)
            self._calibrate_device(frames_dev[:2])
            new = layers.act_scales(self.model)
        growth = max(float(new[k] / torch.clamp_min(old[k], 1e-10)) for k in new)
        if growth > 1.05:
            log.warning(
                "int8 act_scales grew %.1f%% on a sampled batch: earlier clips were "
                "quantized with too-small scales; scales updated from here on. Consider "
                "calibrate() on representative frames up front.", (growth - 1) * 100)

    def prepare_batch(self, frames: np.ndarray) -> tuple[torch.Tensor, float]:
        """Upload [B, H, W, 3] uint8 BGR and letterbox it on the device to the
        configured bucket (or pad to a multiple of 32 when long_side is 0).
        Returns (frames on the device, scale bucket -> native)."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        b, h, w = frames.shape[:3]
        if self.cfg.long_side > 0:
            nh, nw, scale = letterbox_params(h, w, self.cfg.long_side)
            if (nh, nw) != (h, w):
                x = resize_bilinear_uint8(x, nh, nw)
            return x, scale
        pad_h, pad_w = (-h) % 32, (-w) % 32
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        return x, 1.0

    def _priors_for(self, h: int, w: int) -> torch.Tensor:
        if (h, w) not in self._priors:
            self._priors[(h, w)] = torch.from_numpy(
                self.prior_boxes((h, w)).copy()).to(self.device)
        return self._priors[(h, w)]

    @torch.inference_mode()
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, H, W, 3] uint8 BGR on the device, letterboxed.
        Returns packed [B / stride, K, 16] f32: boxes 0:4, score 4, keep 5,
        landmarks 6:16, in bucket pixel coordinates. With a detect stride the
        network sees every stride-th frame only; the caller keeps the whole
        batch on the device for the crop stage."""
        h, w = frames.shape[1], frames.shape[2]
        if self.cfg.stride > 1:
            frames = frames[::self.cfg.stride]
        loc, conf, landms = self.model(retinaface_normalize(frames))
        priors = self._priors_for(h, w)
        scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=self.device)
        boxes = box_ops.decode_boxes(loc.float(), priors) * scale
        lscale = torch.tensor([w, h] * 5, dtype=torch.float32, device=self.device)
        landms = box_ops.decode_landmarks(landms.float(), priors) * lscale
        k = min(self.cfg.nms_candidates, 64)
        cand_boxes, cand_scores, valid, idx = nms_ops.topk_candidates(
            boxes, conf[..., 1], k, self.cfg.threshold)
        keep = nms_mask(cand_boxes.contiguous(), valid.contiguous(), self.cfg.nms_thresh)
        cand_landms = torch.gather(landms, 1, idx[..., None].expand(-1, -1, 10))
        return torch.cat([cand_boxes, cand_scores[..., None],
                          keep.float()[..., None], cand_landms], dim=-1)

    def dispatch(self, frames: np.ndarray) -> tuple[torch.Tensor, float, torch.Tensor]:
        """Enqueue detection for a batch: (packed on the device, scale,
        letterboxed frames on the device for the crop stage)."""
        frames_dev, scale = self.prepare_batch(frames)
        if self.quant:
            self._watch_calibration(frames_dev)
        return self.forward(frames_dev), scale, frames_dev

    @staticmethod
    def unpack(packed_np: np.ndarray, scale: float) -> Detections:
        inv = 1.0 / scale
        return Detections(
            boxes=packed_np[..., 0:4] * inv,
            scores=packed_np[..., 4],
            keep=packed_np[..., 5] > 0.5,
            landmarks=packed_np[..., 6:16] * inv,
        )
