"""Detector training (avcer_tpu/train/detection.py): anchor matching, box
encoding, the multibox loss, the synthetic-face harness and the bucket
recall study.

- ``match_anchors``, ``encode_boxes_np``, ``render_face_scene``: host numpy
  and cv2, copies of the JAX package's functions (``tests/
  test_torch_train_data.py`` pins them).
- ``multibox_loss``: smooth-L1 over positive anchors plus softmax CE with
  hard-negative mining at 7 negatives a positive, in torch (stable argsorts,
  as ``jnp.argsort``).
- ``train_synthetic_detector``: a RetinaFace (``raw_conf``) trained with Adam
  on rendered scenes. As in the JAX package the model runs on its running
  BatchNorm statistics (no batch statistics), and Adam moves those
  statistics too: the JAX package's optimizer state covers the whole
  variable tree, ``batch_stats`` included.
- ``evaluate_bucket_recall``: per-face-size recall and IoU of the port's
  ``DetectStage`` at native resolution (bucket 0) and letterbox buckets; on
  the card its greedy NMS is the K1 kernel.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

VARIANCES = (0.1, 0.2)


def _point_form(priors_cc: np.ndarray) -> np.ndarray:
    """center-size -> xyxy."""
    return np.concatenate(
        [priors_cc[:, :2] - priors_cc[:, 2:] / 2,
         priors_cc[:, :2] + priors_cc[:, 2:] / 2], axis=1
    )


def _jaccard_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU [N, M] in xyxy normalized coords (no +1)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / np.maximum(area_a + area_b - inter, 1e-12)


def encode_boxes_np(
    matched_xyxy: np.ndarray, priors_cc: np.ndarray,
    variances: tuple[float, float] = VARIANCES,
) -> np.ndarray:
    """gt xyxy vs prior center-size -> variance-scaled (dcx, dcy, log w,
    log h) regression targets."""
    g_cxcy = (matched_xyxy[:, :2] + matched_xyxy[:, 2:]) / 2 - priors_cc[:, :2]
    g_cxcy /= variances[0] * priors_cc[:, 2:]
    g_wh = (matched_xyxy[:, 2:] - matched_xyxy[:, :2]) / priors_cc[:, 2:]
    g_wh = np.log(np.maximum(g_wh, 1e-12)) / variances[1]
    return np.concatenate([g_cxcy, g_wh], axis=1).astype(np.float32)


def match_anchors(
    truths_xyxy: np.ndarray,  # [num_obj, 4] normalized xyxy
    priors_cc: np.ndarray,  # [A, 4] center-size (ops.boxes.prior_boxes output)
    threshold: float = 0.35,
    variances: tuple[float, float] = VARIANCES,
) -> tuple[np.ndarray, np.ndarray]:
    """(loc_t [A, 4] float32, conf_t [A] int32; 1 = face, 0 = bg): the best
    prior of each gt forced to overlap 2 (after dropping gts whose best prior
    overlaps < 0.2), best gt per anchor with the force loop, background below
    ``threshold``."""
    a = priors_cc.shape[0]
    if truths_xyxy.shape[0] == 0:
        return np.zeros((a, 4), np.float32), np.zeros(a, np.int32)
    overlaps = _jaccard_np(truths_xyxy, _point_form(priors_cc))  # [N, A]
    best_prior_overlap = overlaps.max(1)
    best_prior_idx = overlaps.argmax(1)
    valid_gt = best_prior_overlap >= 0.2
    if not valid_gt.any():
        return np.zeros((a, 4), np.float32), np.zeros(a, np.int32)
    best_truth_overlap = overlaps.max(0)
    best_truth_idx = overlaps.argmax(0)
    best_truth_overlap[best_prior_idx[valid_gt]] = 2.0
    for j in range(len(best_prior_idx)):  # ensure every gt keeps its best prior
        best_truth_idx[best_prior_idx[j]] = j
    matches = truths_xyxy[best_truth_idx]
    conf = np.ones(a, np.int32)
    conf[best_truth_overlap < threshold] = 0
    loc_t = encode_boxes_np(matches, priors_cc, variances)
    return loc_t, conf


def render_face_scene(
    rng: np.random.Generator,
    hw: tuple[int, int],
    face_sizes: list[int],
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic scene: textured background + schematic
    'faces' (skin ellipse, two dark eyes, dark mouth) at the given pixel
    sizes. Returns (image [H, W, 3] uint8 BGR, boxes [N, 4] xyxy pixels)."""
    import cv2

    h, w = hw
    img = rng.integers(60, 120, (h // 8, w // 8, 3), np.uint8)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    boxes = []
    for s in face_sizes:
        fw, fh = s, int(s * 1.25)
        x = int(rng.integers(4, max(5, w - fw - 4)))
        y = int(rng.integers(4, max(5, h - fh - 4)))
        cx, cy = x + fw // 2, y + fh // 2
        cv2.ellipse(img, (cx, cy), (fw // 2, fh // 2), 0, 0, 360,
                    (150, 170, 215), -1)
        er = max(1, s // 10)
        cv2.circle(img, (cx - fw // 4, cy - fh // 6), er, (25, 25, 25), -1)
        cv2.circle(img, (cx + fw // 4, cy - fh // 6), er, (25, 25, 25), -1)
        cv2.ellipse(img, (cx, cy + fh // 4), (max(1, fw // 5), max(1, fh // 12)),
                    0, 0, 360, (30, 30, 60), -1)
        boxes.append([x, y, x + fw, y + fh])
    return img, np.asarray(boxes, np.float32).reshape(-1, 4)


def multibox_loss(
    loc_pred: torch.Tensor,  # [B, A, 4]
    conf_logits: torch.Tensor,  # [B, A, 2] raw logits
    loc_t: torch.Tensor,  # [B, A, 4]
    conf_t: torch.Tensor,  # [B, A] int
) -> torch.Tensor:
    """SSD multibox loss: smooth-L1 over positive anchors + softmax CE with
    hard-negative mining at 7 negatives per positive."""
    pos = conf_t > 0
    num_pos = torch.clamp_min(pos.sum(), 1)
    diff = loc_pred.float() - loc_t.float()
    l1 = torch.where(diff.abs() < 1.0, 0.5 * diff * diff, diff.abs() - 0.5)
    loss_loc = (l1.sum(-1) * pos).sum() / num_pos

    logp = torch.log_softmax(conf_logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, conf_t.long()[..., None])[..., 0]
    # hard negative mining: rank background anchors by loss, keep 7x positives
    neg_ce = torch.where(pos, torch.full_like(ce, -torch.inf), ce).detach()
    rank = torch.argsort(torch.argsort(-neg_ce, dim=1, stable=True), dim=1, stable=True)
    num_neg = torch.clamp(7 * pos.sum(1, keepdim=True), 1, pos.shape[1] - 1)
    neg = (rank < num_neg) & ~pos
    loss_conf = (ce * (pos | neg)).sum() / num_pos
    return loss_loc + loss_conf


def train_synthetic_detector(
    steps: int = 300,
    image_size: int = 256,
    batch: int = 4,
    seed: int = 0,
    lr: float = 1e-3,
    backbone: str = "mobilenet0.25",
    face_size_range: tuple[int, int] = (16, 128),
    device: str | torch.device = "cuda",
) -> tuple[dict[str, torch.Tensor], list[float]]:
    """Train a small RetinaFace on rendered faces. Returns (its state dict on
    the CPU, the loss of every step)."""
    from avcer_tpu_torch.models import layers
    from avcer_tpu_torch.models.retinaface import RetinaFace
    from avcer_tpu_torch.ops import boxes as box_ops
    from avcer_tpu_torch.ops.image import retinaface_normalize

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    model = RetinaFace(backbone=backbone, raw_conf=True)
    layers.seeded_init_(model, torch.Generator().manual_seed(seed))
    model.to(device).eval()  # BatchNorm on its running statistics
    stats = [b for name, b in model.named_buffers()
             if name.endswith(("running_mean", "running_var"))]
    for b in stats:
        b.requires_grad_(True)
    opt = torch.optim.Adam(list(model.parameters()) + stats, lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    priors = box_ops.prior_boxes((image_size, image_size))
    scale = np.array([image_size] * 4, np.float32)
    losses = []
    try:
        for _ in range(steps):
            images = np.zeros((batch, image_size, image_size, 3), np.float32)
            loc_ts, conf_ts = [], []
            for b in range(batch):
                sizes = [int(rng.integers(*face_size_range))
                         for _ in range(int(rng.integers(1, 4)))]
                img, bx = render_face_scene(rng, (image_size, image_size), sizes)
                images[b] = img
                loc_t, conf_t = match_anchors(bx / scale, priors)
                loc_ts.append(loc_t)
                conf_ts.append(conf_t)
            loc, conf, _ = model(retinaface_normalize(torch.from_numpy(images).to(device)))
            loss = multibox_loss(loc, conf, torch.from_numpy(np.stack(loc_ts)).to(device),
                                 torch.from_numpy(np.stack(conf_ts)).to(device))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            layers.drop_caches(model)
            losses.append(float(loss.detach()))
    finally:
        for b in stats:
            b.requires_grad_(False)
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}, losses


def evaluate_bucket_recall(
    state_dict: Mapping[str, torch.Tensor],
    scene_hw: tuple[int, int],
    buckets: list[int],
    size_bins: list[int],
    n_scenes: int = 8,
    seed: int = 100,
    threshold: float = 0.5,
    backbone: str = "mobilenet0.25",
    quant: str = "none",
    device: str | torch.device = "cuda",
) -> dict:
    """Per-face-size recall and localisation IoU of the detection stage at
    native resolution (bucket 0) against letterbox buckets: {bucket: {size:
    {recall, mean_iou}}}. The detector ``state_dict`` (``train_synthetic_
    detector``'s) in f32, batches of one scene."""
    from avcer_tpu_torch.core.config import DetectorConfig
    from avcer_tpu_torch.models.retinaface import RetinaFace
    from avcer_tpu_torch.pipeline.detect import DetectStage

    results: dict = {}
    for bucket in buckets:
        cfg = DetectorConfig(
            backbone=backbone, long_side=bucket, threshold=threshold,
            dtype="float32", transfer_format="bgr", batch_size=1, quant=quant,
        )
        model = RetinaFace(backbone=backbone, quant=quant == "int8")
        model.load_state_dict(state_dict, strict=True)
        model.eval().requires_grad_(False)
        stage = DetectStage(cfg, model.to(device), device=device)
        if quant != "none":
            img0, _ = render_face_scene(
                np.random.default_rng(seed + 7), scene_hw, list(size_bins))
            stage.calibrate(img0[None])
        hits = {s: [] for s in size_bins}
        ious = {s: [] for s in size_bins}
        rng = np.random.default_rng(seed)
        for _ in range(n_scenes):
            sizes = list(size_bins)
            img, gt = render_face_scene(rng, scene_hw, sizes)
            packed, scale, _ = stage.dispatch(img[None])
            det = DetectStage.unpack(packed.cpu().numpy(), scale)
            kept = det.boxes[0][det.keep[0]]
            for s, g in zip(sizes, gt):
                if kept.shape[0] == 0:
                    hits[s].append(0.0)
                    continue
                iou = _jaccard_np(g[None], kept).max()
                hits[s].append(float(iou > 0.5))
                if iou > 0.5:
                    ious[s].append(float(iou))
        results[bucket] = {
            s: {
                "recall": float(np.mean(hits[s])),
                "mean_iou": float(np.mean(ious[s])) if ious[s] else 0.0,
            }
            for s in size_bins
        }
    return results
