#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (avcer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles every CUDA kernel from csrc/ with nvcc (sm_90a);
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (NMS keep masks equal; attention within the stated
   tolerance), with median times over 50 runs;
4. reference: each model's output on the card (bf16, kernels) against the
   same seeded weights in f32 on the CPU (plain versions), on a small input;
5. main path: the full-width audio-visual pipeline (RetinaFace-r50 @640,
   EmotionResNet50, LSTM, wav2vec2-large 12 layers + ExprModel V3) over an
   8 s synthetic 640x360 clip and a 16 kHz wav: one warm-up run, then three
   timed runs, each with its outputs and the launch counts of both kernels
   checked.

Prints a JSON line of kernel results, then, last, one JSON object with the
device. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from avcer_tpu.core.config import (AudioConfig, DetectorConfig,  # noqa: E402
                                   PipelineConfig, VisualConfig)
from avcer_tpu_torch import _build  # noqa: E402
from avcer_tpu_torch.ops.cuda import attention_kernel, nms_kernel  # noqa: E402
from avcer_tpu_torch.pipeline.builder import build_pipeline  # noqa: E402
from avcer_tpu_torch.pipeline.media import ArrayReader  # noqa: E402

CLIP_SECONDS, FPS, WIDTH, HEIGHT = 8, 25, 640, 360
NMS_SHAPE = (32, 64)  # detector batch, candidates per frame
ATTN_SHAPE = (16, 16, 199, 64)  # audio batch, heads, frames of a 4 s window, head dim
TIMED_RUNS = 3  # after one warm-up run; the host's clock varies from run to run


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in took.items())})")
    for name in _build.KERNELS:
        for line in _build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def median_ms(fn, runs: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nms_case(seed: int, b: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Boxes as tests/test_pallas_kernels.py makes them, plus exact duplicate
    rows and integer boxes at IoU exactly 0.4 (kept) and 0.5 (suppressed)."""
    rng = np.random.default_rng(seed)
    cx, cy = (rng.uniform(0, 200, (b, k)).astype(np.float32) for _ in range(2))
    w, h = (rng.uniform(5, 80, (b, k)).astype(np.float32) for _ in range(2))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)
    valid = -np.sort(-rng.random((b, k)).astype(np.float32), axis=1) > 0.3
    boxes[:, 2] = boxes[:, 1]
    boxes[:, 5] = [300, 300, 309, 309]
    boxes[:, 6] = [300, 300, 309, 303]
    boxes[:, 7] = [300, 300, 309, 304]
    valid[:, :8] = True
    return boxes, valid


def phase_kernels(card: str) -> list[dict]:
    dev = torch.device("cuda")
    # NMS: keep masks must be equal, not close
    mismatches = 0
    for seed in range(4):
        boxes, valid = nms_case(seed, *NMS_SHAPE)
        bt, vt = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
        got = nms_kernel.nms_mask(bt, vt, 0.4)
        want = nms_kernel.nms_mask_plain(bt, vt, 0.4)
        torch.cuda.synchronize()
        mismatches += int((got != want).sum())
        if not bool(got[:, 5].all() and got[:, 6].all() and not got[:, 7].any()):
            raise AssertionError("nms kernel: the IoU 0.4 / 0.5 threshold rows came out wrong")
    if mismatches:
        raise AssertionError(f"nms kernel: {mismatches} keep entries differ from the plain version")
    nms_ms = median_ms(lambda: nms_kernel.nms_mask(bt, vt, 0.4))
    nms_plain_ms = median_ms(lambda: nms_kernel.nms_mask_plain(bt, vt, 0.4))
    log(f"kernel nms_mask [{NMS_SHAPE[0]}, {NMS_SHAPE[1]}, 4]: keep masks equal over 4 seeds; "
        f"{nms_ms:.4f} ms vs plain {nms_plain_ms:.4f} ms (median of 50) on {card}")

    # attention, f32: the JAX package's bound for the Pallas kernel
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=ATTN_SHAPE).astype(np.float32)).to(dev)
               for _ in range(3))
    err32 = float((attention_kernel.mha(q, k, v) - attention_kernel.mha_plain(q, k, v)).abs().max())
    torch.testing.assert_close(attention_kernel.mha(q, k, v), attention_kernel.mha_plain(q, k, v),
                               atol=2e-5, rtol=1e-4)
    # bf16 (the main path's dtype): both sides work in f32 from the same bf16
    # inputs and the kernel rounds to bf16, within 2**-8 relative of the f32
    # result; atol covers f32 summation-order differences near zero
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    got = attention_kernel.mha(qb, kb, vb).float()
    want = attention_kernel.mha_plain(qb.float(), kb.float(), vb.float())
    err16 = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=4e-3)
    attn_ms = median_ms(lambda: attention_kernel.mha(qb, kb, vb))
    attn_plain_ms = median_ms(lambda: attention_kernel.mha_plain(qb, kb, vb))
    log(f"kernel mha {list(ATTN_SHAPE)}: f32 max abs err {err32:.3g} (atol 2e-5, rtol 1e-4); "
        f"bf16 max abs err {err16:.3g} vs f32 plain (atol 1e-5, rtol 4e-3); "
        f"bf16 {attn_ms:.4f} ms vs plain {attn_plain_ms:.4f} ms (median of 50) on {card}")
    return [
        {"name": "nms_mask", "route": "cuda", "source": "avcer_tpu_torch/csrc/nms.cu",
         "replaces": "avcer_tpu/ops/pallas/nms_kernel.py:62", "launches": 0,
         "max_abs_err": float(mismatches), "ms": nms_ms, "plain_ms": nms_plain_ms},
        {"name": "mha", "route": "cuda", "source": "avcer_tpu_torch/csrc/attention.cu",
         "replaces": "avcer_tpu/ops/pallas/attention_kernel.py:40", "launches": 0,
         "max_abs_err": err16, "ms": attn_ms, "plain_ms": attn_plain_ms},
    ]


def smoke_config(dtype: str) -> PipelineConfig:
    return PipelineConfig(
        detector=DetectorConfig(batch_size=32, long_side=640, transfer_format="bgr", dtype=dtype),
        visual=VisualConfig(batch_size=256, dtype=dtype),
        audio=AudioConfig(batch_size=16, dtype=dtype),
        weights_dir=os.path.join(ROOT, "build", "smoke_no_weights"),
        save_plot=False,
    )


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-12))


def phase_reference(pipe, frames: np.ndarray, wav: np.ndarray) -> None:
    """Each model on the card (bf16, CUDA kernels) against the same seeded
    weights in f32 on the CPU (plain versions), one small input each. bf16
    keeps 8 significant bits (2**-8 relative per rounding) and the errors of
    some 60 layers add up; a relative L2 error under 5 % passes, while a
    wrong kernel, layout or weight gives errors of order 100 %."""
    ref = build_pipeline(smoke_config("float32"), device="cpu", seed=0)
    dev = torch.device("cuda")
    with torch.inference_mode():
        x = torch.from_numpy(frames[:1])
        lb, _ = pipe.detect.inner.prepare_batch(frames[:1])
        from avcer_tpu_torch.ops.image import retinaface_normalize, vggface_normalize
        det_card = pipe.detect.inner.model(retinaface_normalize(lb))
        det_cpu = ref.detect.model(retinaface_normalize(lb.cpu()))
        crop = x[:, 60:284, 200:424]  # a 224 x 224 crop
        emo_card = pipe.visual.static_model(vggface_normalize(crop.to(dev)))
        emo_cpu = ref.visual.static_model(vggface_normalize(crop))
        win = torch.from_numpy(wav[None, :64000])
        from avcer_tpu_torch.ops.audio import feature_extractor_normalize
        aud_card = pipe.audio.model(feature_extractor_normalize(win.to(dev)))
        aud_cpu = ref.audio.model(feature_extractor_normalize(win))
    errs = {
        "detector loc": rel_l2(det_card[0], det_cpu[0]),
        "detector conf": rel_l2(det_card[1], det_cpu[1]),
        "detector landmarks": rel_l2(det_card[2], det_cpu[2]),
        "emotion logits": rel_l2(emo_card[0], emo_cpu[0]),
        "emotion features": rel_l2(emo_card[1], emo_cpu[1]),
        "audio logits": rel_l2(aud_card, aud_cpu),
    }
    log("reference (card bf16 vs CPU f32, relative L2): "
        + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v < 0.05}
    if bad:
        raise AssertionError(f"card outputs disagree with the f32 CPU reference: {bad}")


class ForceTopFace:
    """The real detect stage, in full, but each frame's top candidate is its
    one face: with random weights nothing scores like a face, and yet up to
    64 candidates pass the 0.8 threshold, which no real clip has and which
    makes the host tracker (O(N*M) Python per frame) the whole wall time.
    ``raw_kept`` counts the candidates the detector itself kept."""

    def __init__(self, inner, h: int, w: int):
        self.inner, self.h, self.w = inner, h, w
        self.raw_kept = 0
        self.frames = 0

    def dispatch(self, frames):
        return self.inner.dispatch(frames)

    def unpack(self, packed_np, scale):
        det = self.inner.unpack(packed_np, scale)
        self.raw_kept += int(det.keep.sum())
        self.frames += det.keep.shape[0]
        det.keep = np.zeros_like(det.keep)
        det.keep[:, 0] = True
        det.scores = np.array(det.scores)
        det.scores[:, 0] = np.maximum(det.scores[:, 0], 0.9)
        det.boxes = np.array(det.boxes)
        for i in range(det.boxes.shape[0]):
            x1, y1, x2, y2 = det.boxes[i, 0]
            if not (0 <= x1 < x2 <= self.w and 0 <= y1 < y2 <= self.h
                    and x2 - x1 > 8 and y2 - y1 > 8):
                det.boxes[i, 0] = [self.w * 0.25, self.h * 0.25, self.w * 0.75, self.h * 0.75]
        return det


def make_clip() -> tuple[np.ndarray, np.ndarray]:
    """Random base frame plus a moving bright square; 16 kHz noise wav."""
    rng = np.random.default_rng(0)
    n = CLIP_SECONDS * FPS
    base = rng.integers(0, 255, size=(HEIGHT, WIDTH, 3), dtype=np.uint8)
    frames = np.repeat(base[None], n, axis=0)
    for i in range(n):
        x0, y0 = (i * 7) % (WIDTH - 120), (i * 3) % (HEIGHT - 120)
        frames[i, y0:y0 + 120, x0:x0 + 120] = rng.integers(100, 255, (120, 120, 3), dtype=np.uint8)
    wav = (rng.normal(size=CLIP_SECONDS * 16000) * 0.1).astype(np.float32)
    return frames, wav


def phase_main(card: str, kernels: list[dict]) -> None:
    t0 = time.perf_counter()
    pipe = build_pipeline(smoke_config("bfloat16"), device="cuda", seed=0)
    pipe.detect = ForceTopFace(pipe.detect, HEIGHT, WIDTH)
    log(f"build_pipeline (full width, seeded init, bf16): {time.perf_counter() - t0:.2f} s")
    frames, wav = make_clip()
    phase_reference(pipe, frames, wav)

    t0 = time.perf_counter()
    pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    torch.cuda.synchronize()
    log(f"main path warm-up run: {time.perf_counter() - t0:.2f} s")

    walls = []
    for run in range(1, TIMED_RUNS + 1):
        nms_kernel.nms_mask.launches = 0
        attention_kernel.mha.launches = 0
        pipe.detect.raw_kept = pipe.detect.frames = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = {"nms_mask": nms_kernel.nms_mask.launches, "mha": attention_kernel.mha.launches}
        check_main_path(clip, frames.shape[0], launches)
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in clip.timings.items())
        log(f"main path timed run {run}: {stages} on {card}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"detector kept {pipe.detect.raw_kept / max(pipe.detect.frames, 1):.1f} candidates "
        "per frame before the top one was forced to be the only face")
    wall = float(np.median(walls))
    log(f"main path: {frames.shape[0]} frames ({CLIP_SECONDS} s of video), wall per run "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, median {wall:.3f} s = "
        f"{CLIP_SECONDS / wall:.3f} video-sec/sec on {card}; launches per run {launches}")


def check_main_path(clip, n: int, launches: dict[str, int]) -> None:
    """Shapes and values of one run's outputs, and each kernel's launches in
    that run."""
    detect_batches = -(-n // 32)
    audio_batches = -(-len(clip.audio_window_logits) // 16)
    checks = {
        "stat_probs is [T, 7]": clip.stat_probs.shape == (n, 7),
        "stat_probs rows sum to 1": bool(np.allclose(clip.stat_probs.sum(1), 1.0, atol=1e-3)),
        "dyn_logits finite": bool(np.isfinite(clip.dyn_logits).all()),
        "audio logits finite": bool(np.isfinite(clip.audio_window_logits).all()),
        "audio logits are [17, 8]": clip.audio_window_logits.shape == (17, 8),
        "compound.av in 0..6": bool(clip.compound is not None
                                    and set(np.unique(clip.compound.av)) <= set(range(7))),
        f"nms launches == {detect_batches} detect batches": launches["nms_mask"] == detect_batches,
        f"attention launches == 12 x {audio_batches} audio batches":
            launches["mha"] == 12 * audio_batches,
    }
    for name, ok in checks.items():
        log(f"  check {name}: {'ok' if ok else 'FAILED'}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}; launches {launches}")


def main() -> int:
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    phase_main(card, kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
