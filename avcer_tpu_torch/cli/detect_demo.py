"""Face-detection demo CLI (avcer_tpu/cli/detect_demo.py), the reference's
face_detection_test.py equivalent: runs a chosen detector (RetinaFace
resnet50 / mobilenet0.25, or S3FD) over a video, prints the frame count,
the frames with a face and the fps, and optionally writes an annotated copy.

    python -m avcer_tpu_torch.cli.detect_demo --input clip.mp4 --method s3fd \\
        [--weights_dir weights] [--output out.avi] [--device cuda]

Weights: the release file in ``--weights_dir`` (``s3fd_weights.pth``, or the
detector's file of ``core.checkpoint.TORCH_FILES``; ``--weights`` names
another file there), loaded strictly, else a seeded random init with a
warning. The detector runs in bf16 at the ``--long_side`` letterbox bucket,
batches of 32 frames; S3FD's NMS is the card's NMS kernel in its no-+1 mode.
``--device`` defaults to cuda and raises where CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

log = logging.getLogger("avcer_tpu_torch")


def build_stage(method: str, backbone: str, threshold: float, long_side: int,
                weights_dir: str, weights: str = "", device: str = "cuda", seed: int = 0):
    """The detect stage of ``method`` with its model in bf16 on ``device``."""
    from avcer_tpu_torch.core import checkpoint, convert
    from avcer_tpu_torch.core.config import DetectorConfig
    from avcer_tpu_torch.models.layers import cast_compute, seeded_init_

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    cfg = DetectorConfig(backbone=backbone, threshold=threshold, long_side=long_side)
    if method == "s3fd":
        from avcer_tpu_torch.models.s3fd import S3FDNet
        from avcer_tpu_torch.pipeline.detect_s3fd import S3FDStage

        model, family, converter_family, stage_cls = S3FDNet(), "s3fd", "s3fd", S3FDStage
    else:
        from avcer_tpu_torch.models.retinaface import RetinaFace
        from avcer_tpu_torch.pipeline.detect import DetectStage

        model, stage_cls = RetinaFace(backbone=backbone), DetectStage
        family, converter_family = checkpoint.detector_family(backbone), "retinaface"
    sd = checkpoint.resolve(weights_dir, family, torch_file=weights or None)
    if sd is None:
        log.warning("no checkpoint for %s under %s — using seeded random initialization "
                    "(outputs will not match the published model)", family, weights_dir)
        seeded_init_(model, torch.Generator().manual_seed(seed))
        if method == "s3fd":
            model.reset_l2norm_scales()
    else:
        model.load_state_dict(convert.release_state_dict(converter_family, sd), strict=True)
    model.eval().requires_grad_(False)
    model = cast_compute(model, torch.bfloat16).to(device)
    return stage_cls(cfg, model, device=device)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    p = argparse.ArgumentParser(description="avcer-tpu PyTorch/CUDA face detection demo")
    p.add_argument("--input", "-i", required=True, help="video path")
    p.add_argument("--output", "-o", default="", help="annotated output video")
    p.add_argument("--method", "-m", default="retinaface",
                   choices=["retinaface", "s3fd"])
    p.add_argument("--weights", "-w", default="")
    p.add_argument("--benchmark", "-b", default="resnet50",
                   choices=["resnet50", "mobilenet0.25"])
    p.add_argument("--threshold", "-t", type=float, default=0.8)
    p.add_argument("--long_side", type=int, default=640)
    p.add_argument("--weights_dir", default="weights")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises if CUDA is unavailable")
    a = p.parse_args(argv)

    from avcer_tpu_torch.pipeline import media
    from avcer_tpu_torch.pipeline.tracker import IoUTracker

    stage = build_stage(a.method, a.benchmark, a.threshold, a.long_side, a.weights_dir,
                        a.weights, a.device)
    tracker = IoUTracker(iou_threshold=stage.cfg.tracker_iou)
    reader = media.VideoReader(a.input)

    boxes_per_frame = []
    t0 = time.perf_counter()
    n = 0
    for frames, n_valid in reader.batches(stage.cfg.batch_size):
        packed, scale, _ = stage.dispatch(frames)
        det = stage.unpack(packed.cpu().numpy(), scale)
        for i in range(n_valid):
            kept = det.keep[i]
            rows = np.concatenate(
                [det.boxes[i][kept], det.scores[i][kept][:, None]], axis=1
            )
            tracker(rows)
            boxes_per_frame.append(rows[0] if len(rows) else None)
            n += 1
    wall = time.perf_counter() - t0
    found = sum(1 for b in boxes_per_frame if b is not None)
    print(f"{n} frames, faces on {found}, {n / max(wall, 1e-9):.1f} fps")

    if a.output:
        from avcer_tpu_torch.utils.overlay import render_overlay_video

        probs = np.zeros((n, 7), np.float32)  # no emotion model in the demo
        render_overlay_video(a.input, a.output, boxes_per_frame, probs)
        print(f"annotated video written to {a.output}")
    reader.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
