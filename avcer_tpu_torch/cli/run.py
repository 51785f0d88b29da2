"""CLI entry point: ``python -m avcer_tpu_torch.cli.run --path_video V
--path_save S [--device cuda]``.

The surface of ``avcer_tpu.cli.run``: the same core flags, the same output
tree, the same final real-time-factor and throughput lines, and the same
``--serving_profile`` presets, mapped to the same configuration:

- ``parity``: the RetinaFace-r50 detector at the 640 bucket, the emotion CNN
  and LSTM, wav2vec2 + ExprModel V3, all exact;
- ``balanced``: the same models and arithmetic at the 448 bucket;
- ``int8``: the parity models with calibrated int8 convs and projections in
  all three stages; ``int8_s2`` adds detect stride 2 (boxes interpolated
  between detections, the gap-mode tracker), ``int8_448`` the 448 bucket,
  ``int8_448_s2`` both;
- ``fast``: int8 with the mobilenet0.25 detector (detect batches of 128);
  ``turbo``: fast at the 448 bucket with detect stride 2; ``max``: turbo with
  the static CNN on the dynamic step cadence only (``--cnn_stride 0``; the
  dynamic stream is unchanged).

Every quantised profile shares the audio conv feature extractor across a
clip's overlapping windows; ``--exact_audio`` keeps the per-window extraction.
``--long_side``, ``--detect_stride`` and ``--cnn_stride`` override the preset
when given. ``--fused`` runs the r50 detector's and the emotion CNN's
bottleneck chains, and either detector's FPN, SSH modules and heads, through
the fused CUDA kernels (same weights, same outputs up to rounding). A
directory of clips is served through ``Pipeline.run_many``, two clips at a
time. ``--profile_dir DIR`` runs the single-clip ``Pipeline.run`` under
``torch.profiler`` (CPU, and CUDA on a card) and writes a Chrome trace into
DIR, and beside it ``spans.json``: the clip's spans by name (self time, and
the card's idle time in each span of the serving thread), its counters and
launches, and the process's set-up spans (``utils.trace``). The JAX CLI's
other flags are served as there: ``--audio_head v1|v2|v3``
(default v3 with ``--audio_classes 8``, v2 with 7; the 7-class audio CSV
goes to ``audio_<padding>_<step>/``), the port's own ``--audio_encoder
wav2vec2-large-robust-12|wavlm-large`` beside it (WavLM-Large,
``models.wavlm``, under the head in wav2vec2's place; default wav2vec2, the
JAX package's; no quantised profile serves WavLM), ``--save_face_crops``
(the host-crop path, detect stride 1 only: every tracklet's crops as jpgs under
``<save>/<clip>/``) and ``--heatmaps static|dynamic`` (Grad-CAM overlays of
the step frames under ``<save>/<clip>/heatmaps_<mode>/``). Release
checkpoints in ``--weights_dir`` are loaded (``core.checkpoint``), and the
port's int8 calibration sidecars beside them adopted. ``--data_parallel N``
serves over a data-parallel mesh of N devices (``MeshConfig(data=N)``, see
``pipeline.builder``); with fewer devices the build raises the mesh error.
Frames cross to the card in the JAX package's default wire format, I420
(``pipeline.detect``). ``--calibrate`` measures the emotion CNN's and the
audio stage's batch sizes on the card and caches the winners per card and
configuration (``pipeline.calibrate``). ``--compile_cache_dir DIR`` (else
``AVCER_COMPILE_CACHE``, else ``build/avcer_tpu_torch/``) is where the CUDA
kernels' libraries are built and loaded from (``_build``), so that a restart
loads them warm; "" (or 0, off, none, disabled) builds them anew into a
temporary directory. ``--device`` defaults to cuda and never falls back to
the CPU on its own.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import logging
import os
import sys
import time

from avcer_tpu_torch.core.config import (AudioConfig, DetectorConfig, FusionConfig,
                                         MeshConfig, PipelineConfig, VisualConfig)

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
PROFILES = ("parity", "balanced", "int8", "int8_s2", "int8_448", "int8_448_s2", "fast", "turbo",
            "max")


def parse_args(argv=None) -> argparse.Namespace:
    from avcer_tpu_torch.models.audio_heads import ENCODERS

    p = argparse.ArgumentParser(description="avcer-tpu PyTorch/CUDA run")
    p.add_argument("--path_video", type=str, default="video/")
    p.add_argument("--path_save", type=str, default="report/")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises if CUDA is unavailable")
    p.add_argument("--long_side", type=int, default=None,
                   help="detector bucket (default 640; 448 in the balanced, int8_448*, turbo "
                        "and max presets); 0 = native resolution padded to /32")
    p.add_argument("--no_published_weights", action="store_true")
    p.add_argument("--ce_weights_type", action="store_true")
    p.add_argument("--no_ce_mask", action="store_true")
    p.add_argument("--audio_padding", choices=["mean", "constant", "repeat"], default="mean")
    p.add_argument("--audio_step", type=float, default=0.5)
    p.add_argument("--weights_dir", type=str, default="weights")
    p.add_argument("--detect_stride", type=int, default=None,
                   help="detect every Nth frame (default 1; 2 in the int8_s2, int8_448_s2, "
                        "turbo and max presets); boxes are interpolated between detections, "
                        "the CNN still runs on every frame")
    p.add_argument("--cnn_stride", type=int, default=None,
                   help="run the static CNN at most every N frames, plus every dynamic step "
                        "frame (the LSTM stream stays exact); skipped frames hold the last "
                        "computed static probabilities. 0 = the dynamic step cadence. "
                        "Default 1 (every frame); the max preset sets 0")
    p.add_argument("--serving_profile", default="parity", choices=PROFILES,
                   help="speed/quality presets, see the module docstring; explicit flags "
                        "override the preset")
    p.add_argument("--exact_audio", action="store_true",
                   help="keep the per-window audio feature extraction on the quantised "
                        "profiles (turns the shared extractor off)")
    p.add_argument("--fused", action="store_true",
                   help="run the r50 detector's and the emotion CNN's bottleneck chains, and "
                        "the detector's FPN + SSH + heads (either backbone), as fused CUDA "
                        "kernels")
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--heatmaps", choices=["", "static", "dynamic"], default="")
    p.add_argument("--save_face_crops", action="store_true")
    p.add_argument("--audio_classes", type=int, choices=[7, 8], default=8)
    p.add_argument("--audio_head", choices=["v1", "v2", "v3"], default=None,
                   help="default: v3 for 8 classes, v2 for 7 (the reference's pairing)")
    p.add_argument("--audio_encoder", choices=list(ENCODERS), default=AudioConfig.encoder,
                   help="the encoder under the audio head: wav2vec2-large-robust-12 (default) "
                        "or wavlm-large (no int8 profile serves it)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of the run here, and spans.json")
    p.add_argument("--calibrate", action="store_true",
                   help="measure the CNN and audio batch sizes on this card once and cache "
                        "them (pipeline.calibrate)")
    p.add_argument("--compile_cache_dir", type=str, default=None,
                   help="the CUDA kernels' library cache (default $AVCER_COMPILE_CACHE, else "
                        "build/avcer_tpu_torch/); '' builds into a temporary directory")
    a = p.parse_args(argv)
    a.audio_head = a.audio_head or ("v3" if a.audio_classes == 8 else "v2")
    return a


@contextlib.contextmanager
def profiled(path: str, device="cuda"):
    """``torch.profiler`` over the body (CPU activity, and CUDA where
    ``device`` is a GPU); on exit the Chrome trace goes to
    ``path/trace.json`` and the spans of the clips served in the body, joined
    with the device's intervals, to ``path/spans.json`` (``trace.report``)."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    from avcer_tpu_torch.utils import trace

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    since = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, TRACE_FILE))
    with open(os.path.join(path, SPANS_FILE), "w") as f:
        json.dump(trace.report(trace.device_intervals(prof), since), f, indent=1)


def config_from_args(a: argparse.Namespace) -> PipelineConfig:
    """The JAX package's ``pipeline_config_from_args`` mapping, field for
    field, and the port's ``--audio_encoder``."""
    profile = a.serving_profile
    quant = "none" if profile in ("parity", "balanced") else "int8"
    mobilenet = profile in ("fast", "turbo", "max")
    small_bucket = profile in ("turbo", "max", "balanced", "int8_448", "int8_448_s2")
    strided = profile in ("turbo", "max", "int8_s2", "int8_448_s2")
    # None = flag not given: the preset decides (an explicit --long_side 640
    # with turbo stays 640)
    long_side = a.long_side if a.long_side is not None else (448 if small_bucket else 640)
    stride = a.detect_stride if a.detect_stride is not None else (2 if strided else 1)
    cnn_stride = a.cnn_stride if a.cnn_stride is not None else (0 if profile == "max" else 1)
    return PipelineConfig(
        detector=DetectorConfig(
            long_side=long_side, stride=stride, quant=quant,
            backbone="mobilenet0.25" if mobilenet else "resnet50",
            # the mobilenet presets serve detect batches of 128, as in the JAX package
            batch_size=128 if mobilenet else 32,
            fused_layer1=a.fused, fused_tails=a.fused, fused_entries=a.fused,
            fused_ssh=a.fused, fused_fpn=a.fused),
        visual=VisualConfig(quant=quant, fused=a.fused, fused_entries=a.fused,
                            cnn_stride=cnn_stride),
        # every quantised profile shares the conv feature extractor across the
        # windows unless --exact_audio
        audio=AudioConfig(padding=a.audio_padding, step_sec=a.audio_step, quant=quant,
                          shared_extractor=quant == "int8" and not a.exact_audio,
                          head=a.audio_head, num_classes=a.audio_classes,
                          encoder=a.audio_encoder),
        fusion=FusionConfig(use_published_weights=not a.no_published_weights,
                            ce_weights_type=a.ce_weights_type, ce_mask=not a.no_ce_mask),
        mesh=MeshConfig(data=a.data_parallel),
        save_face_crops=a.save_face_crops, heatmaps=a.heatmaps,
        calibrate=a.calibrate,
        weights_dir=a.weights_dir,
    )


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    a = parse_args(argv)
    if a.compile_cache_dir is not None:  # before any kernel is loaded
        from avcer_tpu_torch import _build

        _build.set_cache_dir(a.compile_cache_dir)
    from avcer_tpu_torch.pipeline.builder import build_pipeline

    pipe = build_pipeline(config_from_args(a), device=a.device)  # raises without CUDA

    if os.path.isdir(a.path_video):  # a directory of clips, two at a time
        paths = sorted(p for p in glob.glob(os.path.join(a.path_video, "*"))
                       if p.lower().endswith((".mp4", ".avi", ".mkv", ".mov", ".webm")))
        if not paths:
            print(f"no videos found under {a.path_video}")
            return 1
        t0 = time.perf_counter()
        clips = pipe.run_many(paths, a.path_save)
        # elapsed time: the clips' own walls overlap under run_many
        total_wall = time.perf_counter() - t0
        total_video = sum(c.total_frames / max(c.fps, 1) for c in clips)
        print(f"Processed {len(clips)} clips: "
              f"{total_video / max(total_wall, 1e-9):.2f} video-sec/sec")
        return 0

    print(f"Face images detection in video: {a.path_video}")
    if a.profile_dir:
        with profiled(a.profile_dir, a.device):
            clip = pipe.run(a.path_video, a.path_save)
        print(f"Profiler trace written to {a.profile_dir}")
    else:
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
