"""Fixed-shape candidate selection and greedy NMS (avcer_tpu/ops/nms.py).

``topk_candidates`` keeps the top-k scores per frame with ties resolved
lower index first, as ``lax.top_k`` does; a stable descending sort gives that
order on every device (``torch.topk`` on CUDA does not promise it).
``nms_mask`` is the plain version of the greedy suppression: legacy +1 IoU
(RetinaFace) or, with ``plus_one=False``, the plain IoU of S3FD; strict ``>``
suppresses, rows in score order. On the card the detect stage
goes through the kernel wrapper ``ops.cuda.nms_kernel.nms_mask`` instead.
"""

from __future__ import annotations

import torch


def iou_matrix_legacy(boxes: torch.Tensor, plus_one: bool = True) -> torch.Tensor:
    """Pairwise IoU of [..., K, 4] xyxy boxes -> [..., K, K], in the operation
    order of avcer_tpu/ops/boxes.py iou_matrix_legacy: with ``plus_one`` the
    legacy +1 on widths and heights of the RetinaFace NMS, without it the S3FD
    NMS's (an offset of 0 in the same operations)."""
    off = 1.0 if plus_one else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + off) * (y2 - y1 + off)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = (xx2 - xx1 + off).clamp_min(0.0)
    h = (yy2 - yy1 + off).clamp_min(0.0)
    inter = w * h
    return inter / (areas[..., :, None] + areas[..., None, :] - inter)


def nms_mask(
    boxes: torch.Tensor,  # [B, K, 4] xyxy, rows sorted by descending score
    valid: torch.Tensor,  # [B, K] bool
    iou_thresh: float = 0.4,
    plus_one: bool = True,
) -> torch.Tensor:
    """Greedy suppression mask, True = kept (py_cpu_nms semantics: a row is
    suppressed by a kept, valid, higher-scored row with IoU > thresh).
    ``plus_one=False`` gives the S3FD IoU convention."""
    suppress = iou_matrix_legacy(boxes, plus_one) > iou_thresh  # [B, K, K]
    k = boxes.shape[-2]
    ar = torch.arange(k, device=boxes.device)
    later = ar[None, :] > ar[:, None]  # [i, j]: j after i
    keep = torch.ones_like(valid)
    for i in range(k):
        row_active = keep[:, i] & valid[:, i]
        keep = keep & ~(suppress[:, i, :] & later[i] & row_active[:, None])
    return keep & valid


def topk_candidates(
    boxes: torch.Tensor,  # [B, A, 4]
    scores: torch.Tensor,  # [B, A]
    k: int,
    score_thresh: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k candidates per frame: (boxes [B,k,4], scores [B,k], valid [B,k],
    idx [B,k]) in descending score order, ties lower index first."""
    idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    top_scores = torch.gather(scores, 1, idx)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
    return top_boxes, top_scores, top_scores > score_thresh, idx
