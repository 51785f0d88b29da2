"""One-shot batch-size calibration on the card (avcer_tpu/pipeline/calibrate.py).

The emotion CNN's and the audio stage's batch sizes are throughput knobs.
``calibrate`` times each candidate on the attached device, applies the
fastest to the pipeline and caches the record per card and configuration, so
that every later run adopts it without measuring (``cli.run --calibrate``).

The timing is the JAX package's slope method: the time of ``n2`` calls less
that of ``n1`` calls, each run ending in ``torch.cuda.synchronize()``, over
``n2 - n1``, so that the constant cost of the barrier cancels. A CNN
candidate is timed on one batch of crops from 32 seeded 360 x 640 frames
(``VisualStage.static_batch``, the stage's per-batch forward without the
first batch's int8 refinement), an audio candidate on one batch of windows of
40 s of seeded noise (``AudioStage.forward_windows`` with the stage's padding
and, where it is on, the shared extractor's feature stream made once before
the timing).

The JAX package holds every batch size to identical per-item results. On the
card cuDNN and cuBLAS choose their algorithms by shape, so a crop's CNN output
may move with the batch size by a rounding; ``cnn_stride`` serving stays
bit-equal because every batch still has exactly ``batch_size`` crops.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import time

import numpy as np
import torch

log = logging.getLogger("avcer_tpu_torch")

# per-user cache path: a world-shared /tmp file could be pre-created or
# poisoned by another user on a multi-tenant host
DEFAULT_CACHE = os.path.join(
    tempfile.gettempdir(),
    f"avcer_calibration_torch_{getattr(os, 'getuid', lambda: 'u')()}.json",
)


def _time_slope(fn, sync, n1: int = 2, n2: int = 8) -> float:
    """Seconds a call: (time of n2 calls - time of n1 calls) / (n2 - n1),
    after one warm-up call; ``sync`` waits for the device."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n1):
        fn()
    sync()
    ta = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n2):
        fn()
    sync()
    tb = time.perf_counter() - t0
    return (tb - ta) / (n2 - n1)


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _cache_key(pipe) -> str:
    """The card (``torch.cuda.get_device_name``, or ``cpu``) and the
    configuration the optima depend on: backbone, audio head, CNN dtype, the
    three stages' quantisation (an exact record must not serve int8), the
    shared extractor, and the mesh's data axis (a CNN batch must divide over
    it)."""
    cfg = pipe.cfg
    return "|".join([
        _device_kind(pipe.device),
        cfg.detector.backbone,
        cfg.audio.head,
        str(cfg.visual.dtype),
        cfg.detector.quant,
        cfg.visual.quant,
        cfg.audio.quant,
        str(cfg.audio.shared_extractor),
        f"data{cfg.mesh.data}",
    ])


def valid_record(rec) -> bool:
    """Self-consistency of a cached record before it is adopted: a corrupt or
    hand-edited entry is measured again, not applied. The caller's candidate
    lists do not gate a hit: the cache says "this card and configuration were
    measured once"."""
    return (
        isinstance(rec, dict)
        and isinstance(rec.get("visual_batch"), int)
        and isinstance(rec.get("audio_batch"), int)
        and rec["visual_batch"] > 0
        and rec["audio_batch"] > 0
        and str(rec["visual_batch"]) in rec.get("cnn_ms_per_frame", {})
        and str(rec["audio_batch"]) in rec.get("audio_ms_per_window", {})
    )


@torch.inference_mode()
def calibrate(
    pipe,
    cache_path: str | None = DEFAULT_CACHE,
    cnn_batches: tuple[int, ...] = (64, 128, 256, 512),
    audio_batches: tuple[int, ...] = (8, 16, 32),
) -> dict:
    """Time the emotion CNN and the audio stage at the candidate batch sizes
    on ``pipe``'s device, apply the fastest of each to ``pipe`` and cache the
    record in ``cache_path`` (None: no cache). A valid cached record for the
    same key is applied without measuring. Returns the record."""
    key = _cache_key(pipe)
    cache: dict = {}
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except (OSError, json.JSONDecodeError):
            cache = {}
        if not isinstance(cache, dict):  # a hand-edited file: measured again, rewritten
            cache = {}
        rec = cache.get(key)
        if valid_record(rec):
            apply_calibration(pipe, rec)
            return rec

    device = pipe.device

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(0)
    frames_dev = torch.from_numpy(rng.integers(0, 255, (32, 360, 640, 3), np.uint8)).to(device)
    shards = pipe.mesh.local_data if pipe.mesh is not None else 1
    cnn_ms = {}
    for bs in cnn_batches:
        if bs % shards:
            log.info("calibrate: crop-CNN b%d skipped: it does not divide over the %d devices "
                     "of the data axis", bs, shards)
            continue
        idx = torch.from_numpy(np.arange(bs) % 32).to(device)
        boxes = torch.tensor([[160, 90, 480, 270]], device=device).expand(bs, 4)
        sec = _time_slope(lambda: pipe.visual.static_batch(frames_dev, idx, boxes), sync)
        cnn_ms[bs] = sec / bs * 1e3
        log.info("calibrate: crop-CNN b%d -> %.3f ms/frame", bs, cnn_ms[bs])
    if not cnn_ms:
        raise ValueError(f"calibrate: no CNN candidate of {cnn_batches} divides over the "
                         f"{shards} devices of the data axis")

    audio = pipe.audio
    wav = rng.normal(size=40 * 16_000).astype(np.float32)
    wav_dev = torch.from_numpy(np.pad(wav, (0, audio.window + 1))).to(device)
    feats = audio.shared_features(wav_dev, len(wav)) if audio.cfg.shared_extractor else None
    audio_ms = {}
    for bs in audio_batches:
        starts = torch.from_numpy(np.arange(bs) * 8000 % (len(wav) - audio.window)).to(device)
        sec = _time_slope(lambda: audio.forward_windows(wav_dev, len(wav), starts, feats), sync,
                          n1=2, n2=6)
        audio_ms[bs] = sec / bs * 1e3
        log.info("calibrate: audio b%d -> %.3f ms/window", bs, audio_ms[bs])

    record = {
        "visual_batch": min(cnn_ms, key=cnn_ms.get),
        "audio_batch": min(audio_ms, key=audio_ms.get),
        "cnn_ms_per_frame": {str(k): round(v, 4) for k, v in cnn_ms.items()},
        "audio_ms_per_window": {str(k): round(v, 4) for k, v in audio_ms.items()},
    }
    apply_calibration(pipe, record)
    if cache_path:
        cache[key] = record
        tmp = cache_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=2)
        os.replace(tmp, cache_path)
    return record


def apply_calibration(pipe, record: dict) -> None:
    pipe.visual.batch_size = int(record["visual_batch"])
    pipe.audio.cfg = dataclasses.replace(pipe.audio.cfg, batch_size=int(record["audio_batch"]))
