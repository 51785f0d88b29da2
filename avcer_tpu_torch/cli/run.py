"""CLI entry point: ``python -m avcer_tpu_torch.cli.run --path_video V
--path_save S [--device cuda]``.

The surface of ``avcer_tpu.cli.run`` (same core flags, same output tree, same
final real-time-factor and throughput lines) for the parity profile: the
RetinaFace-r50 detector at the 640 bucket, the emotion CNN and LSTM, and
wav2vec2 + ExprModel V3; and for ``--serving_profile int8``: the same models
with calibrated int8 convs and projections in all three stages and the
audio conv feature extractor shared across a clip's overlapping windows
(``--exact_audio`` keeps the per-window extraction). ``--fused`` runs the detector's and the emotion
CNN's bottleneck chains and the detector's FPN, SSH modules and heads
through the fused CUDA kernels (same weights, same outputs up to rounding).
Flags for what the port does not run yet exit with an error that names the
ROADMAP item porting it. ``--device`` defaults to
cuda and never falls back to the CPU on its own.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
import time

from avcer_tpu_torch.core.config import (AudioConfig, DetectorConfig, FusionConfig,
                                         PipelineConfig, VisualConfig)

NOT_PORTED = {
    "serving_profile": "ROADMAP queue 1 item 12, serving presets: detect stride, the 448 "
                       "bucket, cnn_stride and the mobilenet0.25 backbone (only 'parity' and "
                       "'int8' are ported)",
    "data_parallel": "ROADMAP queue 1, parallelism",
    "heatmaps": "ROADMAP queue 1, other modules: Grad-CAM heatmaps",
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="avcer-tpu PyTorch/CUDA run")
    p.add_argument("--path_video", type=str, default="video/")
    p.add_argument("--path_save", type=str, default="report/")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises if CUDA is unavailable")
    p.add_argument("--long_side", type=int, default=640,
                   help="detector bucket; 0 = native resolution padded to /32")
    p.add_argument("--no_published_weights", action="store_true")
    p.add_argument("--ce_weights_type", action="store_true")
    p.add_argument("--no_ce_mask", action="store_true")
    p.add_argument("--audio_padding", choices=["mean", "constant", "repeat"], default="mean")
    p.add_argument("--audio_step", type=float, default=0.5)
    p.add_argument("--weights_dir", type=str, default="weights")
    p.add_argument("--serving_profile", default="parity",
                   choices=["parity", "balanced", "int8", "int8_s2", "int8_448",
                            "int8_448_s2", "fast", "turbo", "max"])
    p.add_argument("--exact_audio", action="store_true",
                   help="keep the per-window audio feature extraction on the int8 profile "
                        "(turns the shared extractor off)")
    p.add_argument("--fused", action="store_true",
                   help="run the r50 detector's and the emotion CNN's bottleneck chains, and "
                        "the detector's FPN + SSH + heads, as fused CUDA kernels")
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--heatmaps", choices=["", "static", "dynamic"], default="")
    a = p.parse_args(argv)
    asked = {"serving_profile": a.serving_profile not in ("parity", "int8"),
             "data_parallel": a.data_parallel > 1, "heatmaps": bool(a.heatmaps)}
    for flag, hit in asked.items():
        if hit:
            p.error(f"--{flag} is not ported yet ({NOT_PORTED[flag]})")
    return a


def config_from_args(a: argparse.Namespace) -> PipelineConfig:
    quant = "int8" if a.serving_profile == "int8" else "none"
    return PipelineConfig(
        detector=DetectorConfig(
            long_side=a.long_side, batch_size=32, transfer_format="bgr", quant=quant,
            fused_layer1=a.fused, fused_tails=a.fused, fused_entries=a.fused,
            fused_ssh=a.fused, fused_fpn=a.fused),
        visual=VisualConfig(quant=quant, fused=a.fused, fused_entries=a.fused),
        # every quantised profile shares the conv feature extractor across the
        # windows unless --exact_audio
        audio=AudioConfig(padding=a.audio_padding, step_sec=a.audio_step, quant=quant,
                          shared_extractor=quant == "int8" and not a.exact_audio),
        fusion=FusionConfig(use_published_weights=not a.no_published_weights,
                            ce_weights_type=a.ce_weights_type, ce_mask=not a.no_ce_mask),
        weights_dir=a.weights_dir,
    )


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    a = parse_args(argv)
    from avcer_tpu_torch.pipeline.builder import build_pipeline

    pipe = build_pipeline(config_from_args(a), device=a.device)  # raises without CUDA

    if os.path.isdir(a.path_video):  # a directory of clips, one after another
        paths = sorted(p for p in glob.glob(os.path.join(a.path_video, "*"))
                       if p.lower().endswith((".mp4", ".avi", ".mkv", ".mov", ".webm")))
        if not paths:
            print(f"no videos found under {a.path_video}")
            return 1
        t0 = time.perf_counter()
        clips = [pipe.run(p, a.path_save) for p in paths]
        total_wall = time.perf_counter() - t0
        total_video = sum(c.total_frames / max(c.fps, 1) for c in clips)
        print(f"Processed {len(clips)} clips: "
              f"{total_video / max(total_wall, 1e-9):.2f} video-sec/sec")
        return 0

    print(f"Face images detection in video: {a.path_video}")
    clip = pipe.run(a.path_video, a.path_save)
    print("Compound expression prediction")
    for stage, sec in clip.timings.items():
        print(f"  {stage}: {sec:.3f}s")
    print(f"Real-time factor for compound expression prediction: {clip.rtf:.2f}")
    wall = clip.timings["wall"]
    print(f"Throughput: {clip.total_frames / max(clip.fps, 1) / max(wall, 1e-9):.2f} "
          "video-sec/sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
