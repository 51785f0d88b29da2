"""S3FD detection stage (avcer_tpu/pipeline/detect_s3fd.py), a drop-in
alternative to ``DetectStage`` (the reference's s3fd_predictor.py):

- RGB minus (123, 117, 104) (s3fd_predictor.py:46-52);
- decode with the one-anchor-a-cell priors, top-``min(nms_candidates, 64)``
  candidates above ``threshold``, greedy NMS at IoU 0.3 without the +1
  convention (utils.py:96-152); on the card that is the NMS kernel K1 in its
  ``plus_one=False`` mode;
- the same packed [B, K, 16] rows as ``DetectStage``, landmark slots zero
  (S3FD has no landmark head), so the runner's unpacking and the tracker are
  reused, as is ``DetectStage``'s device letterbox.

Refused, as in the JAX package: a detect stride above 1 (the forward has no
stride slicing) and int8 serving.
"""

from __future__ import annotations

import torch

from avcer_tpu_torch.core.config import DetectorConfig
from avcer_tpu_torch.models.s3fd import s3fd_priors
from avcer_tpu_torch.ops import boxes as box_ops
from avcer_tpu_torch.ops import nms as nms_ops
from avcer_tpu_torch.ops.cuda.nms_kernel import nms_mask
from avcer_tpu_torch.pipeline.detect import DetectStage

#: RGB means subtracted before the network (s3fd_predictor.py:48-50)
S3FD_RGB_MEAN = (123.0, 117.0, 104.0)
#: S3FD's NMS IoU threshold (s3fd_predictor.py:41)
S3FD_NMS_THRESH = 0.3


class S3FDStage(DetectStage):
    """``DetectStage``'s host prep, device letterbox, dispatch and unpack
    with the S3FD network, its anchors and its post-processing."""

    prior_boxes = staticmethod(s3fd_priors)

    def __init__(self, cfg: DetectorConfig, model: torch.nn.Module,
                 device: torch.device | str = "cuda"):
        if cfg.stride > 1:
            # the S3FD forward has no stride slicing: it would emit one row a
            # frame where the runner expects batch_size / stride rows
            raise ValueError(
                "detector stride > 1 is not supported by S3FDStage; use the"
                " RetinaFace stage for stride serving")
        if cfg.quant != "none":
            raise ValueError(
                "quantized serving is not implemented for S3FDStage; use"
                " the RetinaFace stage for int8 serving")
        super().__init__(cfg, model, device)

    @torch.inference_mode()
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, H, W, 3] uint8 BGR on the device, letterboxed.
        Returns packed [B, K, 16] f32: boxes 0:4, score 4, keep 5, zeros
        6:16, in bucket pixel coordinates."""
        h, w = frames.shape[1], frames.shape[2]
        mean = torch.tensor(S3FD_RGB_MEAN, dtype=torch.float32, device=frames.device)
        x = frames.flip(-1).float() - mean
        loc, conf = self.model(x)
        scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=frames.device)
        boxes = box_ops.decode_boxes(loc.float(), self._priors_for(h, w)) * scale
        k = min(self.cfg.nms_candidates, 64)
        cand_boxes, cand_scores, valid, _ = nms_ops.topk_candidates(
            boxes, conf[..., 1], k, self.cfg.threshold)
        keep = nms_mask(cand_boxes.contiguous(), valid.contiguous(), S3FD_NMS_THRESH,
                        plus_one=False)
        return torch.cat([cand_boxes, cand_scores[..., None], keep.float()[..., None],
                          cand_boxes.new_zeros((*cand_boxes.shape[:2], 10))], dim=-1)
