#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (avcer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the five CUDA sources from csrc/ with nvcc (sm_90a), all
   at once, and prints each one's build time, registers and spills;
3. pipelines: the full-width audio-visual pipeline (RetinaFace-r50 @640,
   EmotionResNet50, LSTM, wav2vec2-large 12 layers + ExprModel V3, bf16,
   seeded weights) built four times: unfused and with the seven fused
   switches, each exact and in int8 (``cli.run --serving_profile int8``:
   calibrated static activation scales, the shared audio extractor); then,
   one after another, the pipelines of the other serving presets, each built
   from the configuration ``cli.run`` maps its ``--serving_profile`` to (the
   mobilenet0.25 detector for ``fast``, ``turbo`` and ``max``);
4. kernels: each kernel against its plain PyTorch version at the first main
   paths' shapes (NMS keep masks equal; attention (the tensor-core kernel in
   bf16, the exact kernel in f32, and the tensor-core kernel's bias mode with
   WavLM-Large's 320 buckets, timed beside the unbiased kernel and beside
   scaled_dot_product_attention with the bias built as a mask), fused_chain and
   fused_ssh_heads, exact and in their int8 modes, the latter also at the
   mobilenet detector's 64 channels with leaky ReLU 0.1, and fused_chain_flat
   within the stated tolerances, f32 and bf16), with median times over 50
   runs of the kernel, its plain version and, where there is one, a library
   yardstick (scaled_dot_product_attention; the port's own unfused section
   for the fused kernels: cuDNN, or in int8 torch._int_mm), and the roofline
   bound computed from the inputs; fused_chain at every call shape of the r50
   main paths, each with its plan (work items, cluster size C, grid) and the
   clusters the card holds at once, and where C > 1 held bit for bit against
   the same call at C = 1 (and timed there); its int8 mode on the packed
   weights the models keep, with the blocks an SM the card reports for it at
   every C (the plan's 2, or the phase fails); fused_ssh_heads likewise at each
   of its calls (the r50 detector's scales 2 and 3 in clusters of at least
   128 blocks in all; the int8 option on the packed weights the model keeps,
   two blocks an SM at every C, and for the mobilenet detector also at the
   448 bucket's calls of ``max --fused`` and ``turbo --fused``); nms_mask
   also at the mobilenet presets' detect batch of 128 and at [2, 1000] (no
   path's K), with its device time from a
   profiler trace beside its time a call and the plain version's;
   fused_chain_flat at the seven stride-1 chains of those calls, each
   with its plan (band height, C, grid), equal to fused_chain bit for bit
   and, where C > 1, to C = 1, timed beside fused_chain (its plain version
   over 3 runs); the I420 rebuild (``i420_to_bgr``) at the r50 paths'
   ``[32, 360, 640]`` and the mobilenet presets' ``[128, 252, 448]``, on the
   clip's wire and on random bytes, equal bit for bit to its plain version;
5. reference: each model's output on the card (bf16, kernels), unfused and
   fused, exact and int8, against the same seeded weights (and the same
   activation scales) in f32 on the CPU (plain versions), on a small input;
   the mobilenet detector likewise; the body's depthwise convolutions (library
   calls) timed beside their bytes bound;
6. main path, four times: unfused, fused (``cli.run --fused``), int8 unfused
   and int8 fused (``--serving_profile int8 [--fused]``), on the I420 wire
   (the JAX package's default, as ``cli.run`` serves it): an 8 s synthetic
   640x360 clip and a 16 kHz wav: one warm-up run (in int8 it also refines
   the scales, which then stay frozen), then three timed runs (int8
   unfused: one), each with its
   outputs and the launch counts of the kernels checked (every attention
   launch in the tensor-core kernel); the fused path once more with
   WavLM-Large under the audio head (``--fused --audio_encoder wavlm-large``:
   24 K2 launches an audio batch, a warm-up, three timed runs and a profiled
   run in which every K2 launch is ``mha_tc_bias_kernel``, with its device
   time; ``--phase wavlm`` runs phases 1, 2, this path and the bias mode's
   kernels entry alone); the fused runs' compound decisions
   against the unfused runs'; one more run of the unfused exact path and of
   the int8 fused path under the CLI's ``--profile_dir`` helper, for the
   device's busy and idle share of the wall (every NMS kernel in its trace
   must be nms_bitmask_kernel; in int8 fused, K3's and K4's kernels as often
   as in a timed run, with their device time and share); no timed or profiled run
   packs int8 weights (the models pack them once, when they fold). In every warm-up run, of
   these paths and of the presets', each kernel call with shapes, types or
   modes that no path has shown yet is held against the kernel's plain
   version on the call's own inputs. The I420 rebuild launches once a detect
   batch, as often in the profiled runs' traces. ``parity`` and ``int8
   --fused`` once more with the rebuild on its plain version: every output
   equal to the kernel's run. ``parity`` on the ``bgr`` wire (a second
   pipeline: warm-up and a checked run), then three runs of each wire in
   turns, both medians with their ranges. ``--calibrate``: ``parity`` built
   with it and a temporary cache (every candidate timed, the choice applied),
   a second call that hits the cache and times nothing, and the calibrated
   batches' run against the default one. ``--compile_cache_dir``: the built
   libraries copied to a temporary directory, and a fresh process serving
   ``cli.run --fused --compile_cache_dir DIR`` on a 2 s clip loads all five
   with no nvcc build, with its time to its first kernel launch;
7. release files and the rest of the CLI: the seeded f32 weights written as
   the reference's release files (the detector's ``module.`` prefix, the
   trainer's wrapper, the positional conv's weight-norm factors),
   ``parity --fused`` built from them, its outputs equal to those of the same
   weights handed in directly; then ``--fused --save_face_crops --heatmaps
   static --audio_classes 7`` (the host-crop path) and ``--fused --heatmaps
   dynamic --audio_head v1`` (the device path, V1's GRU), each with every
   distinct kernel call of its warm-up run held against the plain version
   (K1's and K3's too), and in a second run its launches, its jpgs,
   heatmaps and audio CSV checked; V1's audio stage timed against V3's;
8. the presets: ``max --fused`` (three timed runs) and ``turbo`` unfused
   (one) the same way (launch counts: ``fused_ssh_heads`` three times a detect batch
   and every launch with leaky 0.1; ``max --fused`` also one profiled run),
   ``max``'s dynamic stream held bit for
   bit against ``turbo --fused``'s, and one timed run each of ``balanced``,
   ``int8_s2``, ``int8_448``, ``int8_448_s2`` and ``fast`` (``balanced``,
   ``int8_448_s2`` and ``fast`` also with ``--fused``), and ``run_many`` over
   two clips against the serial runs;
9. offline evaluation: ``cli.run --fused`` writes the output trees of the
   smoke clip and its reverse, and ``cli.eval_offline --optimize_weights
   --num_dirichlet 10000 --device cuda`` runs over them with seeded
   annotations; the weight search at full size (N = 2^18 aligned frames, 3
   streams, 7 classes): 10,000 Dirichlet candidates and the 3-way grid of
   1,000, timed by CUDA events, the first 1,024 candidates' UARs equal bit
   for bit to the port's own search on the CPU;
10. preprocessing (host): ``spectral_vad`` with and without
   ``separate_fusion`` on the smoke wav, ``build_vad_pickle`` over it and
   ``extract_surface_area`` over the host-crop path's face crops;
11. ``cli.detect_demo`` on the smoke clip written as a video: S3FD (seeded
   weights written as ``s3fd_weights.pth``, 640, batch 32, bf16), with K1 in
   its no-+1 mode, every distinct call held against the plain version and
   the first batch against an f32 CPU forward of the same weights; then
   RetinaFace r50 through the same CLI;
12. training at full width, on a seeded corpus written in the loaders'
   layouts (two 48 s ABAW videos, five 10 s MELD utterances: 73 windows):
   ``cli.train_audio`` V3 with 8 classes (wav2vec2-large 12 layers, the last
   4 trained, batches of 24 4 s windows, bf16 under autocast, REMAT and
   AUGMENTATION on) for 2 epochs of 3 steps, then ``--resume`` for a third
   with every K2 call held against the plain version, each step timed with
   its loss, K2 launches (8: one a frozen layer) and the last encoder
   layer's q/k/v gradient norms (non-zero); V1 with 7 classes (soft focal),
   every K2 call held; ``cli.train_visual`` static (EmotionResNet50, batches
   of 64 seeded 224 x 224 jpg crops, bf16, 3 steps, the BatchNorm running
   statistics moved) and dynamic (TemporalLSTM on seeded .npz features);
   ``cli.extract_features`` from V3's best export, every K2 call held;
   ``train_synthetic_detector`` (mobilenet0.25, 256, batch 4, 20 steps) and
   ``evaluate_bucket_recall`` through ``DetectStage``, every K1 call held;
   one V3 train step at full width, batch 2, f32, dropout off, on the card
   against the same step on the CPU. The kernels line gives the K1 and K2
   launches of each training path (``launches_by_training_path``).
   ``--phase training`` runs phases 1, 2 and 12 alone (no kernels line);
13. the parallel paths and the rest of the port's modules, on meshes that
   name the one card 2 or 4 times (one process: NCCL refuses two ranks on one
   GPU, and gloo takes CUDA tensors only for all-reduce and broadcast):
   ``parity`` at ``--data_parallel 2`` (K1 at a replica's ``[16, 64, 4]``,
   every distinct K1 and K2 call held, outputs against N = 1); one V3 train
   step at full width (batch 24, REMAT, dropout off) plain, at data 2 x model
   2 and at pipe 2 with 2 microbatches, in f32 and in bf16, each against the
   plain step (K2 8, 32 and 16 launches; K2 at the tensor-parallel shard
   ``[12, 8, 199, 64]``), and once more on inputs nudged by one f32 ulp (the
   gradient's own conditioning); ``cli.convert_verify --calib_video
   --golden`` on the release written in phase 7, then ``int8 --fused`` built
   from it with its sidecars adopted (K3 / K4 int8 held); ``launch_sim
   --processes 2`` on the host (gloo); the Keras LSTM converter where h5py is
   installed (else a line says why it did not run). The kernels line gives
   ``launches_by_parallel_path``, and entries ``nms_mask_dp`` and
   ``mha_tc_tp`` for the new shapes. ``--phase parallel`` runs phases 1, 2,
   one ``parity`` run, the release files and phase 13 alone (no kernels
   line).

Prints a JSON line of kernel results, then, last, one JSON object with the
device. Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import io
import json
import logging
import os
import pickle
import re
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from avcer_tpu_torch import _build  # noqa: E402
from avcer_tpu_torch.cli import run as cli  # noqa: E402
from avcer_tpu_torch.core import checkpoint  # noqa: E402
from avcer_tpu_torch.core.config import (AudioConfig, DetectorConfig,  # noqa: E402
                                         MeshConfig, PipelineConfig, VisualConfig)
from avcer_tpu_torch.models import layers  # noqa: E402
from avcer_tpu_torch.models import retinaface as retinaface_module  # noqa: E402
from avcer_tpu_torch.models import wav2vec2 as wav2vec2_module  # noqa: E402
from avcer_tpu_torch.models import wavlm as wavlm_module  # noqa: E402
from avcer_tpu_torch.models.audio_heads import ENCODERS  # noqa: E402
from avcer_tpu_torch.models.retinaface import (RetinaFace, fold_pairs, nhwc,  # noqa: E402
                                               upsample_nearest_to)
from avcer_tpu_torch.ops.cuda import (attention_kernel, fused_resnet_kernel,  # noqa: E402
                                      fused_ssh_kernel, image_kernel, nms_kernel)
from avcer_tpu_torch.ops.image import resize_bilinear_uint8, retinaface_normalize  # noqa: E402
from avcer_tpu_torch.pipeline import detect as detect_module  # noqa: E402
from avcer_tpu_torch.pipeline import detect_s3fd as detect_s3fd_module  # noqa: E402
from avcer_tpu_torch.pipeline.builder import build_pipeline  # noqa: E402
from avcer_tpu_torch.core import registry  # noqa: E402
from avcer_tpu_torch.pipeline.media import ArrayReader, write_wav  # noqa: E402
from avcer_tpu_torch.pipeline.visual import cnn_compute_sel  # noqa: E402
from avcer_tpu_torch.utils import trace  # noqa: E402

CLIP_SECONDS, FPS, WIDTH, HEIGHT = 8, 25, 640, 360
NMS_SHAPE = (32, 64)  # detector batch, candidates per frame
ATTN_SHAPE = (16, 16, 199, 64)  # audio batch, heads, frames of a 4 s window, head dim
TIMED_RUNS = 3  # after one warm-up run; the host's clock varies from run to run
DETECT_BATCH, CNN_BATCH, AUDIO_BATCH = 32, 256, 16
MNET, MNET_BATCH = "mobilenet0.25", 128  # the detect batch of fast, turbo and max
DEVICE = "cuda"
#: NVIDIA H100 SXM data sheet: dense bf16 and int8 on the tensor cores, f32 on
#: the CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
WRAPPERS = {"nms_mask": nms_kernel.nms_mask, "mha": attention_kernel.mha,
            "fused_chain": fused_resnet_kernel.fused_chain,
            "fused_ssh_heads": fused_ssh_kernel.fused_ssh_heads,
            "fused_chain_flat": fused_resnet_kernel.fused_chain_flat,
            "i420_to_bgr": image_kernel.i420_to_bgr}
#: the modules through which a model or stage reaches each wrapper, and the
#: wrapper's plain version (no model calls fused_chain_flat)
PATH_SITES = {"nms_mask": ((detect_module, detect_s3fd_module), nms_kernel.nms_mask_plain),
              "i420_to_bgr": ((detect_module,), image_kernel.i420_to_bgr_plain),
              "mha": ((wav2vec2_module, wavlm_module), attention_kernel.mha_plain),
              "fused_chain": ((retinaface_module,), fused_resnet_kernel.fused_chain_plain),
              "fused_ssh_heads": ((retinaface_module,), fused_ssh_kernel.fused_ssh_heads_plain)}
#: each main path's launches in its last timed run, by the path's label
PATH_LAUNCHES: dict[str, dict[str, int]] = {}
#: the I420 rebuild's device time a launch in each profiled run, by label
I420_TRACED: dict[str, float] = {}
#: the wires the main paths send the I420 rebuild: the r50 detect batch at the
#: 640 bucket (the clip's 640 x 360 unresized) and the mobilenet presets' at 448
I420_BUCKETS = ((DETECT_BATCH, 640), (MNET_BATCH, 448))
#: calibrated against default batch sizes: the largest difference of a static
#: or audio probability (bf16: another batch may take another library
#: algorithm, a rounding apart in each of some 60 layers), and the share of
#: frames whose compound decision must agree (random weights give near-ties)
CALIB_PROB_TOL, CALIB_AGREE = 0.05, 0.95
#: every distinct kernel call the main paths have made so far, (wrapper, shapes,
#: types and modes of its arguments) -> (the entry of the kernels line it
#: belongs to, the kernel's largest error against its plain version)
HELD: dict[tuple, tuple[str, float]] = {}


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
    log(f"build: {time.perf_counter() - t0:.2f} s wall, all sources at once "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in took.items())})")
    for name in _build.KERNELS:
        entry = ""
        for line in _build.ptxas_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")


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


def device_kernels(fn, runs: int = 20, warmup: int = 3,
                   attempts: int = 3) -> list[dict] | None:
    """The device kernels of ``runs`` calls (after ``warmup``) in a
    ``torch.profiler`` trace: each with its name and duration (us). Every call
    launches at least one kernel, so a trace with fewer kernel events than
    calls lost some: it is taken again, up to ``attempts`` times in all, and
    then None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    path = os.path.join(ROOT, "build", "smoke_traces", "device_ms.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        if len(kernels) >= runs:
            return kernels
        log(f"  profiler trace {attempt} of {attempts}: {len(kernels)} kernel events for "
            f"{runs} calls")
    return None


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_ms(fn, runs: int = 20) -> float | None:
    """Device time of one call: the kernels' own durations in a
    ``torch.profiler`` trace of ``runs`` calls (after 3 warm-ups), summed and
    divided by ``runs`` (None: not measured). Unlike ``median_ms`` it leaves
    out the host's time to launch, which a short kernel does not hide."""
    kernels = device_kernels(fn, runs)
    return None if kernels is None else sum(float(e["dur"]) for e in kernels) / runs * 1e-3


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


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes moved over
    the memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def entry(name: str, source: str, replaces: str, **numbers) -> dict:
    return {"name": name, "route": "cuda", "source": f"avcer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, **numbers}


def kernels_nms_attention(card: str) -> list[dict]:
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
    nms = nms_numbers(bt, vt, got)
    # the mobilenet presets' detect batch, and a large K that no path passes
    cases = []
    for b, k in ((MNET_BATCH, NMS_SHAPE[1]), (2, 1000)):
        boxes, valid = nms_case(4, b, k)
        bm, vm = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
        keep = nms_kernel.nms_mask(bm, vm, 0.4)
        if not torch.equal(keep, nms_kernel.nms_mask_plain(bm, vm, 0.4)):
            raise AssertionError(f"nms kernel: keep masks differ at [{b}, {k}, 4]")
        cases.append(nms_numbers(bm, vm, keep))
    for c in [nms] + cases:
        log(f"kernel nms_mask (nms_bitmask_kernel) {c['shape']}: keep masks equal"
            f"{' over 4 seeds' if c is nms else ''}; {c['ms']:.4f} ms a call (median of 50), "
            f"device time {ms_text(c['device_ms'])} (profiler, 20 calls), vs plain "
            f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.6f} ms ({c['bound_by']}), no "
            f"library call, on {card}")

    # attention, f32: the exact kernel, within the JAX package's bound for the
    # Pallas kernel
    mha, plain = attention_kernel.mha, attention_kernel.mha_plain
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=ATTN_SHAPE).astype(np.float32)).to(dev)
               for _ in range(3))
    ran = mha_kernels_of(lambda: mha(q, k, v))
    got32 = mha(q, k, v)
    err32 = float((got32 - plain(q, k, v)).abs().max())
    torch.testing.assert_close(got32, plain(q, k, v), atol=2e-5, rtol=1e-4)
    # bf16 (the main path's dtype), the tensor-core kernel: both sides work in
    # f32 from the same bf16 inputs and the kernel rounds to bf16, within
    # 2**-8 relative of the f32 result; atol covers f32 summation-order
    # differences near zero (the exp values enter the tensor cores as two bf16
    # parts)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    ran16 = mha_kernels_of(lambda: mha(qb, kb, vb))
    got = mha(qb, kb, vb).float()
    want = plain(qb.float(), kb.float(), vb.float())
    err16 = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=4e-3)
    if (ran, ran16) != ({"exact": 1}, {"tc": 1}):
        raise AssertionError(f"mha routed f32 to {ran} and bf16 to {ran16}")
    # in turns: tensor-core kernel, library call, plain, exact kernel in f32
    # and its library call
    tc_ms = median_ms(lambda: mha(qb, kb, vb))
    tc_lib_ms = median_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb))
    tc_plain_ms = median_ms(lambda: plain(qb, kb, vb))
    exact_ms = median_ms(lambda: mha(q, k, v))
    exact_lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    exact_plain_ms = median_ms(lambda: plain(q, k, v))
    tc_dev = device_ms(lambda: mha(qb, kb, vb))
    tc_lib_dev = device_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb))
    exact_dev = device_ms(lambda: mha(q, k, v))
    b, h, t, d = ATTN_SHAPE
    flops = 4.0 * b * h * t * t * d
    tc_bound, tc_by = bound_ms(4 * tensor_bytes(qb), flops, "bf16")
    # the exact kernel multiplies in f32 on the CUDA cores
    exact_bound, exact_by = bound_ms(4 * tensor_bytes(q), flops, "f32")
    log(f"kernel mha_tc {list(ATTN_SHAPE)} bf16 (tensor cores): max abs err {err16:.3g} vs f32 "
        f"plain (atol 1e-5, rtol 4e-3); {tc_ms:.4f} ms vs plain {tc_plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {tc_lib_ms:.4f} ms (a call, median of 50); device time "
        f"{ms_text(tc_dev)} vs scaled_dot_product_attention's kernels {ms_text(tc_lib_dev)} "
        f"(profiler, 20 calls); bound {tc_bound:.4f} ms ({tc_by}) on {card}")
    log(f"kernel mha_exact {list(ATTN_SHAPE)} f32 (CUDA cores): max abs err {err32:.3g} "
        f"(atol 2e-5, rtol 1e-4); {exact_ms:.4f} ms vs plain {exact_plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {exact_lib_ms:.4f} ms (a call, median of 50); device "
        f"time {ms_text(exact_dev)} (profiler, 20 calls); bound {exact_bound:.4f} ms ({exact_by}) "
        f"on {card}")
    return [
        entry("nms_mask", "nms.cu", "avcer_tpu/ops/pallas/nms_kernel.py:62",
              max_abs_err=float(mismatches), library_ms=None, **nms, cases=cases),
        entry("mha_tc", "attention.cu", "avcer_tpu/ops/pallas/attention_kernel.py:40",
              max_abs_err=err16, ms=tc_ms, plain_ms=tc_plain_ms, bound_ms=tc_bound,
              bound_by=tc_by, library_ms=tc_lib_ms, shape=list(ATTN_SHAPE), dtype="bf16",
              device_ms=tc_dev, library_device_ms=tc_lib_dev),
        entry("mha_exact", "attention.cu", "avcer_tpu/ops/pallas/attention_kernel.py:40",
              max_abs_err=err32, ms=exact_ms, plain_ms=exact_plain_ms, bound_ms=exact_bound,
              bound_by=exact_by, library_ms=exact_lib_ms, shape=list(ATTN_SHAPE), dtype="f32",
              device_ms=exact_dev, on_main_path=False),
    ]


def kernels_mha_bias(card: str) -> dict:
    """K2's bias mode (``mha_tc_bias_kernel``, WavLM-Large's gated relative
    position bias) at the WavLM audio batch ``ATTN_SHAPE`` in bf16 with the
    published 320 buckets over 800 frames: held against the plain version
    with the same bias within the unbiased kernel's tolerance, and timed
    beside the unbiased kernel, the plain version and, as the library
    yardstick, ``scaled_dot_product_attention`` with the bias materialised as
    a [B, H, T, T] bf16 mask (built in each call, as a caller would). The
    bound counts Q, K, V, O, the gate, the table and the bucket map, and the
    bias's multiply-add a logit in f32 beside the products in bf16."""
    mha, plain = attention_kernel.mha, attention_kernel.mha_plain
    b, h, t, d = ATTN_SHAPE
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=ATTN_SHAPE).astype(np.float32))
               .to(DEVICE, torch.bfloat16) for _ in range(3))
    table = torch.from_numpy(rng.normal(scale=0.25, size=(h, 320)).astype(np.float32)).to(DEVICE)
    gate = torch.from_numpy(rng.uniform(1, 3, size=(b * h, t)).astype(np.float32)).to(DEVICE)
    bias = (table, wavlm_module.relative_buckets(t, 320, 800).to(DEVICE), gate)
    ran = mha_kernels_of(lambda: mha(q, k, v, bias=bias))
    got = mha(q, k, v, bias=bias).float()
    want = plain(q.float(), k.float(), v.float(), bias)
    err = float((got - want).abs().max())
    moved = float((want - plain(q.float(), k.float(), v.float())).abs().max())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=4e-3)
    if ran != {"tc": 1}:
        raise AssertionError(f"mha routed the bias to {ran}")
    kernels = device_kernels(lambda: mha(q, k, v, bias=bias))
    names = {e["name"] for e in kernels or ()}
    if kernels is not None and not all("mha_tc_bias_kernel" in n for n in names):
        raise AssertionError(f"mha with a bias ran {sorted(names)}")

    def library():
        mask = attention_kernel.relative_bias(bias, b, h, t).to(torch.bfloat16)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    lib_err = float((library().float() - want).abs().max())
    # in turns: the bias mode, the unbiased kernel, the library call, plain
    ms = median_ms(lambda: mha(q, k, v, bias=bias))
    unbiased_ms = median_ms(lambda: mha(q, k, v))
    lib_ms = median_ms(library)
    plain_ms = median_ms(lambda: plain(q, k, v, bias))
    dev = device_ms(lambda: mha(q, k, v, bias=bias))
    unbiased_dev = device_ms(lambda: mha(q, k, v))
    lib_dev = device_ms(library)
    nbytes = 4 * tensor_bytes(q) + tensor_bytes(*bias)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (4.0 * b * h * t * t * d / PEAK_FLOPS["bf16"]
             + 2.0 * b * h * t * t / PEAK_FLOPS["f32"]) * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"kernel mha_tc_bias {list(ATTN_SHAPE)} bf16, 320 buckets (tensor cores, bias from "
        f"shared memory): max abs err {err:.3g} vs f32 plain with the bias (atol 1e-5, rtol "
        f"4e-3; the bias moves the output by {moved:.3g}); {ms:.4f} ms vs unbiased "
        f"{unbiased_ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention with a "
        f"bf16 [B, H, T, T] mask built a call {lib_ms:.4f} ms (max abs err {lib_err:.3g}) (a "
        f"call, median of 50); device time {ms_text(dev)} vs unbiased {ms_text(unbiased_dev)}, "
        f"the library's mask and kernels {ms_text(lib_dev)} (profiler, 20 calls); bound "
        f"{bound:.4f} ms ({by}) on {card}")
    return entry("mha_tc_bias", "attention.cu", "none (WavLM's gated relative position bias)",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 library_ms=lib_ms, shape=list(ATTN_SHAPE), dtype="bf16", device_ms=dev,
                 unbiased_device_ms=unbiased_dev, library_device_ms=lib_dev,
                 bias_moves_output=moved)


def nms_numbers(boxes: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor,
                thresh: float = 0.4, plus_one: bool = True) -> dict:
    """K1 at one shape and mode: a call and its device time, the plain
    version's time, and the bound of this run's data: row i is compared with
    the K - 1 - i rows after it only while it is kept, about 20 f32
    operations a pair."""
    k = boxes.shape[1]
    pairs = float(((k - 1 - torch.arange(k, device=boxes.device)) * keep).sum())
    bound, by = bound_ms(tensor_bytes(boxes, valid, keep), 20 * pairs, "f32")

    def call():
        return nms_kernel.nms_mask(boxes, valid, thresh, plus_one=plus_one)

    return {"shape": list(boxes.shape), "ms": median_ms(call), "device_ms": device_ms(call),
            "plain_ms": median_ms(
                lambda: nms_kernel.nms_mask_plain(boxes, valid, thresh, plus_one), runs=10),
            "bound_ms": bound, "bound_by": by}


def mha_kernels_of(call) -> dict[str, int]:
    """The attention kernels ``call`` launched, with their launch counts."""
    before = dict(attention_kernel.mha.launches_by_kernel)
    call()
    return {name: n - before[name] for name, n in attention_kernel.mha.launches_by_kernel.items()
            if n != before[name]}


def randn(shape, seed: int, dtype=torch.bfloat16, relu: bool = True) -> torch.Tensor:
    """Activations as a ReLU leaves them, made from a seed with numpy."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    x = torch.from_numpy(x).to(DEVICE)
    return (x.relu() if relu else x).to(dtype).contiguous()


def chain_work(x: torch.Tensor, folded, blocks, out: torch.Tensor) -> tuple[float, float]:
    """(bytes, operations) of one fused_chain call: the input and every weight
    read once, the output written once; two operations per multiply-add."""
    b, h, w, cin = x.shape
    macs = 0
    for kind, t in zip(blocks, fused_resnet_kernel.split_folded(folded, blocks)):
        planes, cout = t[0].shape[1], t[6].shape[1]
        s2 = kind in ("s2ds", "s2pre")
        ho, wo = ((h + 1) // 2, (w + 1) // 2) if s2 else (h, w)
        px1 = b * h * w if kind == "s2ds" else b * ho * wo  # conv1 at input resolution
        px = b * ho * wo
        macs += px1 * cin * planes + px * 9 * planes * planes + px * planes * cout
        if kind != "id":
            macs += px * cin * cout
        h, w, cin = ho, wo, cout
    return float(tensor_bytes(x, out, *folded)), 2.0 * macs


def ssh_work(x, convs, heads, lat, merge, up, outs) -> tuple[float, float]:
    b, h, w, ci = x.shape
    c = convs[0].shape[2]
    q = c // 4
    macs = 9 * (c * c // 2 + c * q + 3 * q * q) + c * sum(t.shape[1] for t in heads[0::2])
    if lat is not None:
        macs += ci * c
    if merge is not None:
        macs += 9 * c * c
    weights = list(convs) + list(heads) + list(lat or ()) + list(merge or ())
    return float(tensor_bytes(x, up, *outs, *weights)), 2.0 * b * h * w * macs


# bf16, kernel against plain from the same bf16 inputs with the same rounding
# points: a sum on a rounding boundary may fall to either side after another
# summation order, one bf16 ulp (2**-8 relative) per conv, carried through up
# to 12 convs of a chain (7 of a scale): a few ulps
BF16_TOL = dict(atol=2 ** -5, rtol=2 ** -5)


# int8, kernel against plain: both quantise with a true f32 division and
# round half to even, sum the int8 products exactly and round twice in f32 in
# the epilogue, so they agree bit for bit unless the two compilers differ by
# an ulp somewhere; a quantised value that flips then moves one term of the
# next conv by one step (amax / 127 times a weight). The bounds are the exact
# kernels' bf16 bounds in both dtypes; measured: equal.
INT8_TOL = dict(atol=2 ** -5, rtol=2 ** -5)


def signature(value):
    """Shapes, types and modes of a call's arguments, not their values."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), str(value.dtype)
    if isinstance(value, (list, tuple)):
        return tuple(signature(v) for v in value)
    return value


def has_tensor(value) -> bool:
    return torch.is_tensor(value) or (isinstance(value, (list, tuple))
                                      and any(has_tensor(v) for v in value))


#: the wrappers whose results must equal their plain versions', and what the
#: hold says when they do
EXACT = {"nms_mask": "keep masks equal", "i420_to_bgr": "equal bit for bit"}


def hold_on_path(name: str, args: tuple, kw: dict):
    """One kernel call of a main path against the kernel's plain version on
    the call's own inputs; returns the kernel's result. NMS keep masks and
    the I420 rebuild must be equal. The others take the tolerances of the kernels phase (attention:
    the plain version in f32 from the same bf16 inputs), with ``atol`` times
    the plain result's largest magnitude where that is above 1: a path's
    activations are not of order 1 as the kernels phase's are, and a bf16 ulp
    of an intermediate value scales with it."""
    wrapper, plain = WRAPPERS[name], PATH_SITES[name][1]
    kw = dict(kw)
    out = kw.pop("out", None)  # a replayed call's: the wrapper writes there
    quant = kw.get("act_s") is not None
    entry_name = name + ("_c64" if name == "fused_ssh_heads" and args[1][0].shape[2] == 64
                         else "") + ("_int8" if quant else "")
    if name == "mha":
        entry_name += "_" + attention_kernel.kernel_for(args[0].dtype, *args[0].shape[2:]) + (
            "_bias" if kw.get("bias") is not None else "")
    got = wrapper(*args, **kw) if out is None else wrapper(*args, **kw, out=out)
    if name in EXACT:
        err, tol = float((got != plain(*args, **kw)).sum()), None
        ok = err == 0
    else:
        with torch.autocast("cuda", enabled=False):  # a training path runs under autocast
            if name == "mha":  # WavLM's bias, f32 and int32, as it is
                want, tol = plain(*(a.float() for a in args), **kw), dict(atol=1e-5, rtol=4e-3)
            else:
                want, tol = plain(*args, **kw), INT8_TOL if quant else BF16_TOL
        pairs = [(g.float(), w.float()) for g, w in zip(
            got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,))]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        largest = max(float(w.abs().max()) for _, w in pairs)
        ok = all(bool(((g - w).abs() <= tol["atol"] * max(1.0, float(w.abs().max()))
                       + tol["rtol"] * w.abs()).all()) for g, w in pairs)
    # this thread's stream only: a device-wide wait fails, and ends the
    # capture, while the detect stage captures its graphs on another thread
    torch.cuda.current_stream().synchronize()
    modes = [a for a in args if not has_tensor(a)] + [
        f"{k}={v}" for k, v in kw.items() if v is not None and not has_tensor(v)]
    log(f"  held on the path: {entry_name} {[list(a.shape) for a in args if torch.is_tensor(a)]} "
        f"{modes}{' + up' if kw.get('up') is not None else ''}: "
        + (EXACT[name] if tol is None and ok else f"max abs err {err:.3g}")
        + ("" if tol is None else f", largest |plain| {largest:.3g} (atol {tol['atol']:.3g} x "
                                  f"max(1, largest |plain|) of each output, rtol {tol['rtol']:.3g})"))
    if not ok:
        raise AssertionError(f"{entry_name} disagrees with its plain version on a main path's "
                             f"call: {signature(args)} {modes}, max abs err {err}")
    return entry_name, err, got


@contextlib.contextmanager
def holding_new_calls(seen: dict | None = None):
    """For the length of a warm-up run: every kernel call whose shapes, types
    and modes no main path has shown yet goes through ``hold_on_path``. The
    timed runs call the wrappers directly. ``seen``: the calls held already,
    ``HELD`` by default (a fresh dict holds every distinct call of the run).
    The detect stage's piecewise graphs: a call made while this thread
    captures a graph (K1 inside one) goes to the wrapper unheld, since a
    hold synchronises, which a capture refuses; the key's eager warm-up
    batch held the same call before. A replayed K3 / K4 call brings
    ``out=``, which is not part of its signature."""
    seen = HELD if seen is None else seen

    def shim(name):
        def call(*args, **kw):
            key = (name, signature(args), signature(tuple(sorted(
                (k, v) for k, v in kw.items() if k != "out"))))
            if key in seen or torch.cuda.is_current_stream_capturing():
                return WRAPPERS[name](*args, **kw)
            entry_name, err, got = hold_on_path(name, args, kw)
            seen[key] = (entry_name, err)
            return got
        return call

    for name, (modules, _) in PATH_SITES.items():
        for module in modules:
            setattr(module, name, shim(name))
    try:
        yield
    finally:
        for name, (modules, _) in PATH_SITES.items():
            for module in modules:
                setattr(module, name, WRAPPERS[name])


def check_fused(name: str, run, run_plain, x, tol32, case: str) -> float:
    """Kernel against plain: f32 on the first 4 frames (the f32 kernel
    multiplies on the CUDA cores; 4 frames reach every tile position), bf16
    at the full batch. ``run(x, dtype)`` and ``run_plain(x, dtype)`` return
    tuples of tensors. Returns the bf16 max abs error."""
    x32 = x[:4].float()
    got, want = run(x32, torch.float32), run_plain(x32, torch.float32)
    torch.cuda.synchronize()
    err32 = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **tol32)
    got, want = run(x, torch.bfloat16), run_plain(x, torch.bfloat16)
    torch.cuda.synchronize()
    err16 = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **BF16_TOL)
    log(f"kernel {name} {case}: f32 (first 4 frames) max abs err {err32:.3g} "
        f"(atol {tol32['atol']}, rtol {tol32['rtol']}); bf16 (full batch) max abs err "
        f"{err16:.3g} (atol 2^-5, rtol 2^-5)")
    return err16


def chain_cases(detector, emotion) -> list:
    """Every fused_chain call of the r50 main paths: (label, layer, blocks of
    the layer, kinds, input shape, runs of the plain version to time). The
    rows since the cluster plan time their plain versions over 10 runs."""
    body = detector.body
    return [
        ("detector layer1", body.layer1, [0, 1, 2], ("ds", "id", "id"), (DETECT_BATCH, 90, 160, 64),
         50),
        ("detector layer2", body.layer2, [0, 1, 2, 3], ("s2ds", "id", "id", "id"),
         (DETECT_BATCH, 90, 160, 256), 50),
        ("detector layer3 entry", body.layer3, [0, 1], ("s2ds", "id"), (DETECT_BATCH, 45, 80, 512),
         50),
        ("detector layer3 tail", body.layer3, [2, 3, 4], ("id", "id", "id"),
         (DETECT_BATCH, 23, 40, 1024), 50),
        ("detector layer3 last", body.layer3, [5], ("id",), (DETECT_BATCH, 23, 40, 1024), 10),
        ("emotion layer1", emotion.layer1, [0, 1, 2], ("ds", "id", "id"), (CNN_BATCH, 55, 55, 64),
         10),
        ("emotion layer2", emotion.layer2, [0, 1, 2], ("s2pre", "id", "id"),
         (CNN_BATCH, 55, 55, 256), 50),
        ("emotion layer2 last", emotion.layer2, [3], ("id",), (CNN_BATCH, 28, 28, 512), 10),
        ("emotion layer3", emotion.layer3, [0, 1, 2], ("s2pre", "id", "id"),
         (CNN_BATCH, 28, 28, 512), 10),
        ("emotion layer3 tail", emotion.layer3, [3, 4, 5], ("id", "id", "id"),
         (CNN_BATCH, 14, 14, 1024), 10),
        ("emotion layer4 tail", emotion.layer4, [1], ("id",), (CNN_BATCH, 7, 7, 2048), 50),
    ]


def chain_plan_of(x: torch.Tensor, folded, blocks, quant: bool) -> dict:
    """The wrapper's plan for this call (work items, C, grid) and what the
    card reported for that launch configuration before its first launch."""
    per_block = fused_resnet_kernel.split_folded(folded, blocks)
    b, h, w, cin = x.shape
    plan = fused_resnet_kernel.chain_plan(
        b, h, w, per_block[0][6].shape[-1], max(t[0].shape[1] for t in per_block), blocks,
        x.element_size(), torch.cuda.get_device_properties(0).multi_processor_count,
        q_cin=cin if quant else 0)
    occ = fused_resnet_kernel.chain_occupancy(x.device, x.dtype, quant, plan["cluster"])
    return {"nwork": plan["nwork"], "cluster": plan["cluster"], "grid": plan["grid"],
            "max_active_clusters": occ["clusters"], "blocks_per_sm": occ["blocks_per_sm"]}


def hold_cluster(name: str, case: str, x: torch.Tensor, run, plan: dict) -> dict:
    """A fused kernel at the plan's C > 1 against the same call at C = 1, bit
    for bit (f32 on the first 4 frames, at their own plan's C, and the dtype
    of ``x`` at the full batch), and the time of both; raises if they differ.
    ``run(a, dtype, cluster)`` launches the kernel through its private launch
    path (``cluster`` None: the plan's C) and returns a tuple of tensors."""
    def same(a, dt):
        return all(torch.equal(g, o) for g, o in zip(run(a, dt, None), run(a, dt, 1)))

    wide = same(x, x.dtype)
    wide32 = same(x[:4].float(), torch.float32)
    one_ms = median_ms(lambda: run(x, x.dtype, 1))
    log(f"  {name} {case}: C = {plan['cluster']} equals C = 1 bit for bit: {wide} (f32, first "
        f"4 frames: {wide32}); C = 1 takes {one_ms:.3f} ms (median of 50)")
    if not (wide and wide32):
        raise AssertionError(f"{name} {case}: C = {plan['cluster']} differs from C = 1")
    return {"c1_ms": one_ms}


def kernels_fused_chain(card: str, detector, emotion, quant: bool = False) -> dict:
    """K3 at the block patterns and widths of the two models, with the models'
    own (seeded) weights; the library yardstick is the same blocks unfused:
    cuDNN (channels-last bf16 convolutions and the port's BatchNorm) or, with
    ``quant`` (the int8 models, their seeded scales), the port's int8 section
    (``torch._int_mm`` over the unfolded input)."""
    rows, worst = [], 0.0
    name = "fused_chain int8" if quant else "fused_chain"
    kind = "int8" if quant else "bf16"
    for seed, (label, layer, chunk, blocks, shape, plain_runs) in enumerate(
            chain_cases(detector, emotion)):
        x = randn(shape, 100 + seed)
        pairs = [p for bi in chunk for p in layer[bi].fold_pairs()]
        # the int8 fold does not depend on the compute dtype: f32 mult and shift
        folded = {dt: fold_pairs(pairs, dt) for dt in (torch.float32, torch.bfloat16)}
        # the kernel's copy of the int8 weights, made once as the models make it
        packed = (fused_resnet_kernel.pack_chain_q(folded[torch.bfloat16][0]) if quant
                  else None)
        section = torch.nn.Sequential(*[layer[bi] for bi in chunk])
        x_cl = x.permute(0, 3, 1, 2)  # NCHW-shaped, channels-last in memory
        case = f"{label} {blocks} {list(shape)}"

        def run(a, dt, fn=fused_resnet_kernel.fused_chain):
            w, act_s = folded[dt]
            return (fn(a, w, blocks, act_s=act_s, packed=packed),)

        def run_plain(a, dt):
            return run(a, dt, fused_resnet_kernel.fused_chain_plain)

        def launch(a, dt, cluster):
            w, act_s = folded[dt]
            return (fused_resnet_kernel._fused_chain_cuda(a, w, blocks, act_s, cluster=cluster,
                                                          packed=packed),)

        plan = chain_plan_of(x, folded[torch.bfloat16][0], blocks, quant)
        log(f"  {case} {kind}: {plan['nwork']} work items, C = {plan['cluster']}, grid "
            f"{plan['grid']}; the card holds {plan['max_active_clusters']} such clusters at "
            f"once, {plan['blocks_per_sm']} blocks an SM")
        worst = max(worst, check_fused(name, run, run_plain, x,
                                       INT8_TOL if quant else dict(atol=2e-4, rtol=1e-3), case))
        with torch.inference_mode():
            lib = section(x_cl).permute(0, 2, 3, 1)
            out = run(x, torch.bfloat16)[0]
            lib_rel = rel_l2(out, lib)
            ms = median_ms(lambda: run(x, torch.bfloat16))
            # the int8 plain version multiplies in float64: fewer timed runs
            plain = median_ms(lambda: run_plain(x, torch.bfloat16),
                              runs=10 if quant else plain_runs)
            lib_ms = median_ms(lambda: section(x_cl))
            if plan["cluster"] > 1:
                plan.update(hold_cluster(name, case, x, launch, plan))
        b_ms, b_by = bound_ms(*chain_work(x, folded[torch.bfloat16][0], blocks, out), kind)
        log(f"  {case} {kind}: kernel {ms:.3f} ms, plain {plain:.3f} ms, unfused "
            f"{'int8' if quant else 'cuDNN'} section {lib_ms:.3f} ms (relative L2 to it "
            f"{lib_rel:.4f}), bound {b_ms:.3f} ms ({b_by}) (median of 50) on {card}")
        # int8: the unfused section rounds to bf16 between the dequantisation
        # and the BatchNorm, the kernel merges the two multiplies, so values
        # near a rounding boundary quantise one step apart downstream
        if not lib_rel < (0.05 if quant else 0.02):
            raise AssertionError(f"{name} {case}: relative L2 {lib_rel} to the unfused section")
        rows.append({"case": label, "blocks": list(blocks), "shape": list(shape), "ms": ms,
                     "plain_ms": plain, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                     **plan})
    first = rows[0]
    extra = {}
    if quant:
        # the int8 product's shared memory leaves two blocks an SM at every C
        occ = {f"{dt} C = {c}": fused_resnet_kernel.chain_occupancy(
                   torch.device(DEVICE), dt, True, c)["blocks_per_sm"]
               for dt in (torch.float32, torch.bfloat16)
               for c in range(1, fused_resnet_kernel.MAX_CLUSTER + 1)}
        log(f"  {name}: product mma.sync m16n8k32 s8 (block_gemm_tc_q); blocks an SM by "
            f"compute dtype and cluster size {occ}")
        if set(occ.values()) != {fused_resnet_kernel.BLOCKS_PER_SM}:
            raise AssertionError(f"{name}: blocks an SM {occ}, the plan assumes "
                                 f"{fused_resnet_kernel.BLOCKS_PER_SM}")
        extra = {"product": "mma.sync m16n8k32 s8",
                 "blocks_per_sm": fused_resnet_kernel.BLOCKS_PER_SM}
    return entry("fused_chain_int8" if quant else "fused_chain", "fused_resnet.cu",
                 "avcer_tpu/ops/pallas/fused_resnet_kernel.py:" + ("219" if quant else "299"),
                 max_abs_err=worst, ms=first["ms"], plain_ms=first["plain_ms"],
                 bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                 library_ms=first["library_ms"], shape=first["shape"], **extra, cases=rows)


def kernels_fused_ssh(card: str, detector, quant: bool = False) -> dict:
    """K4 at the three scales in the fully fused order (scale 3 emits its
    lateral, scale 2 its merged feature, ``up`` the nearest upsample of the
    coarser one) and once with fused_ssh alone (scale 1 after the unfused
    FPN), at the detector's own widths: the r50 model's 256 channels with ReLU
    at its detect batch of 32, or the mobilenet model's 64 channels with leaky
    ReLU 0.1 at its detect batch of 128 (the 640 bucket's three scales; in
    int8 also the 448 bucket's, 64 frames a call, as ``max --fused`` and
    ``turbo --fused`` call it). The int8 option runs on the packed weights
    the model keeps (``_scale_folded``). The library yardstick is the port's
    FPN lateral and merge, SSH module and heads for that scale, unfused:
    cuDNN or, with ``quant``, the int8 modules."""
    c = detector.out_ch
    mobile = detector.backbone == MNET
    batch = MNET_BATCH if mobile else DETECT_BATCH
    leaky = 0.1 if mobile else 0.0
    taps = (64, 128, 256) if mobile else (512, 1024, 2048)
    # (bucket, frames a call, (h, w) of scales 1-3, scale)
    cases = [(640, batch, ((45, 80), (23, 40), (12, 20)), i) for i in (2, 1, 0, "ssh alone")]
    if mobile and quant:
        cases += [(448, 64, ((32, 56), (16, 28), (8, 14)), i) for i in (2, 1, 0)]
    folded = {dt: [detector._scale_folded(i, dt) for i in range(3)]
              for dt in (torch.float32, torch.bfloat16)}
    heads_of = [(detector.BboxHead[i], detector.ClassHead[i], detector.LandmarkHead[i])
                for i in range(3)]
    name = ("fused_ssh_heads" + (" C = 64 leaky 0.1" if mobile else "")
            + (" int8" if quant else ""))
    kind = "int8" if quant else "bf16"
    rows, worst = [], 0.0
    feat_prev = None
    for bucket, frames, sizes, i in cases:
        alone = i == "ssh alone"
        i = 0 if alone else i
        if i == 2:  # a bucket starts at its coarsest scale, which has no up
            feat_prev = None
        # activations as the body's last activation leaves them
        x = randn((frames,) + sizes[i] + (c if alone else taps[i],),
                  (200 if bucket == 640 else 210) + (0 if alone else i), relu=False)
        x = fused_ssh_kernel.activate(x, leaky)
        up = None
        if feat_prev is not None and not alone:
            up = nhwc(upsample_nearest_to(feat_prev.permute(0, 3, 1, 2), x.shape[1:3]))
        emit = i > 0 and not alone

        def args(dt, n=None):
            convs, heads, lat, merge, scales, packed = folded[dt][i]
            u = None if up is None else up[:n].to(dt)
            act_s = None
            if scales is not None:  # the kernel's order: lateral, merge, the SSH convs
                act_s = scales[2] if alone else torch.cat([sx for sx in scales if sx is not None])
                packed = packed[-5:] if alone else packed
            return dict(conv_folded=convs, head_folded=heads, leaky=leaky,
                        fpn_lat=None if alone else lat, fpn_merge=None if alone else merge,
                        up=u, emit_feature=emit, act_s=act_s, packed=packed)

        def run(a, dt):
            return fused_ssh_kernel.fused_ssh_heads(a, **args(dt, a.shape[0]))

        def launch(a, dt, cluster):
            return fused_ssh_kernel._fused_ssh_cuda(a, **args(dt, a.shape[0]), cluster=cluster)

        def run_plain(a, dt):
            return fused_ssh_kernel.fused_ssh_heads_plain(a, **args(dt, a.shape[0]))

        ssh = getattr(detector, f"ssh{i + 1}")

        def library(x_cl, up_cl):
            f = x_cl
            if not alone:
                f = getattr(detector.fpn, f"output{i + 1}")(f)
                if up_cl is not None:
                    f = getattr(detector.fpn, f"merge{i + 1}")(f + up_cl)
            s = ssh(f)
            return tuple(h(s) for h in heads_of[i])

        label = "scale 1 after the unfused FPN" if alone else f"scale {i + 1} with the FPN"
        if bucket != 640:
            label += f" at the {bucket} bucket"
        case = f"{label} {list(x.shape)}" + (" + up" if up is not None else "") + (
            " -> feature" if emit else "")
        a = args(torch.bfloat16)
        plan = fused_ssh_kernel.card_plan(x, c, a["fpn_merge"] is not None, quant)
        plan = {k: plan[k] for k in ("nwork", "cluster", "grid", "max_active_clusters")}
        log(f"  {case} {kind}: {plan['nwork']} work items, C = {plan['cluster']}, grid "
            f"{plan['grid']}; the card holds {plan['max_active_clusters']} such clusters at once")
        if not mobile and not alone and i > 0 and plan["grid"] < 128:
            raise AssertionError(f"{name} {case}: a grid of {plan['grid']} blocks")
        # the sums run over up to 9 x 256 terms after a 2048-term lateral
        worst = max(worst, check_fused(name, run, run_plain, x,
                                       INT8_TOL if quant else dict(atol=2e-5, rtol=1e-4), case))
        with torch.inference_mode():
            outs = run(x, torch.bfloat16)
            x_cl = x.permute(0, 3, 1, 2)
            up_cl = None if up is None else up.permute(0, 3, 1, 2)
            lib = library(x_cl, up_cl)
            lib_rel = max(rel_l2(o.reshape(lb.shape), lb) for o, lb in zip(outs, lib))
            ms = median_ms(lambda: run(x, torch.bfloat16))
            plain = median_ms(lambda: run_plain(x, torch.bfloat16), runs=10 if quant else 50)
            lib_ms = median_ms(lambda: library(x_cl, up_cl))
            if plan["cluster"] > 1:
                plan.update(hold_cluster(name, case, x, launch, plan))
        b_ms, b_by = bound_ms(*ssh_work(x, a["conv_folded"], a["head_folded"], a["fpn_lat"],
                                        a["fpn_merge"], up, outs), kind)
        log(f"  {case} {kind}: kernel {ms:.3f} ms, plain {plain:.3f} ms, unfused "
            f"{'int8' if quant else 'cuDNN'} section {lib_ms:.3f} ms (relative L2 to it "
            f"{lib_rel:.4f}), bound {b_ms:.3f} ms ({b_by}) (median of 50) on {card}")
        if not lib_rel < (0.05 if quant else 0.02):
            raise AssertionError(f"{name} {case}: relative L2 {lib_rel} to the unfused section")
        if emit:
            feat_prev = outs[3]
        rows.append({"case": label, "shape": list(x.shape), "ms": ms, "plain_ms": plain,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, **plan})
    extra = {}
    if quant:
        # the int8 product's shared memory leaves two blocks an SM at every C
        occ = {f"{dt} C = {n}": fused_ssh_kernel.ssh_occupancy(
                   torch.device(DEVICE), dt, True, n)["blocks_per_sm"]
               for dt in (torch.float32, torch.bfloat16)
               for n in range(1, fused_ssh_kernel.MAX_CLUSTER + 1)}
        log(f"  {name}: product mma.sync m16n8k32 s8 (block_gemm_tc_q); blocks an SM by "
            f"compute dtype and cluster size {occ}")
        if set(occ.values()) != {fused_resnet_kernel.BLOCKS_PER_SM}:
            raise AssertionError(f"{name}: blocks an SM {occ}, expected "
                                 f"{fused_resnet_kernel.BLOCKS_PER_SM}")
        extra = {"product": "mma.sync m16n8k32 s8",
                 "blocks_per_sm": fused_resnet_kernel.BLOCKS_PER_SM}
    main = rows[2]  # scale 1 with the FPN at the 640 bucket: the largest of the calls
    return entry("fused_ssh_heads" + ("_c64" if mobile else "") + ("_int8" if quant else ""),
                 "fused_ssh.cu",
                 "avcer_tpu/ops/pallas/fused_ssh_kernel.py:" + ("51" if quant else "198"),
                 max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                 bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                 library_ms=main["library_ms"], shape=main["shape"], leaky=leaky, **extra,
                 cases=rows)


def depthwise_sections(card: str, detector) -> None:
    """The mobilenet body's 13 depthwise 3x3 convolutions (grouped
    ``F.conv2d``: library calls, as in the JAX package they are XLA ops), each
    timed at the shapes two presets give it: 64 frames of 448 x 252 (``turbo``
    and ``max``: a detect batch of 128 at stride 2) and 128 frames of 640 x 360
    (``fast``). The bound is bytes: input and output once each."""
    body = detector.body
    blocks = list(body.stage1)[1:] + list(body.stage2) + list(body.stage3)
    for label, shape in (("turbo / max", (64, 3, 252, 448)), ("fast", (128, 3, 360, 640))):
        x = randn(shape, 500, relu=False).contiguous(memory_format=torch.channels_last)
        total = bound = pw_total = 0.0
        with torch.inference_mode():
            h = body.stage1[0](x)
            for blk in blocks:
                dw, rest = blk[0], torch.nn.Sequential(*list(blk)[1:])
                out = dw(h)
                ms = median_ms(lambda: dw(h), runs=20)
                pw_total += median_ms(lambda: rest(out), runs=20)
                b_ms = tensor_bytes(h, out, dw.weight) / PEAK_BYTES * 1e3
                total, bound = total + ms, bound + b_ms
                log(f"  depthwise 3x3 s{dw.stride[0]} {list(h.shape)} ({label}): {ms:.4f} ms, "
                    f"bytes bound {b_ms:.4f} ms")
                h = rest(out)
        log(f"depthwise convolutions of the mobilenet body, {label} {list(shape)}: 13 calls "
            f"{total:.3f} ms in all, bytes bound {bound:.3f} ms; the rest of the 13 blocks "
            f"(BatchNorm, leaky ReLU, pointwise {'int8' if detector.quant else 'bf16'} conv) "
            f"{pw_total:.3f} ms (median of 20 each) on {card}")


def kernels_fused_chain_flat(card: str, detector, emotion) -> dict:
    """K5, which no model calls: the three small f32 cases of the JAX
    package's test of its flat kernel, and the seven stride-1 chains of the
    main paths (the two models' own weights, bf16), each with its plan (band
    height, work items, C, grid), against its plain version, against
    fused_chain bit for bit, at C > 1 against C = 1 bit for bit, and timed
    beside fused_chain, its plain version (3 runs) and the unfused cuDNN
    section."""
    flat, chain = fused_resnet_kernel.fused_chain_flat, fused_resnet_kernel.fused_chain
    rng = np.random.default_rng(300)

    def triple(shape):
        c = shape[-1]
        return [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
            rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1])),
            rng.uniform(0.5, 1.5, (1, c)), rng.normal(size=(1, c)) * 0.1)]

    worst32 = 0.0
    for shape, blocks, band in (((2, 13, 17, 64), ("ds", "id", "id"), 8),
                                ((1, 37, 29, 128), ("id", "id"), 16),
                                ((1, 24, 16, 64), ("ds",), 24)):
        cin, planes = shape[-1], 24
        cout = cin if blocks[0] == "id" else 64
        folded = []
        for kind in blocks:
            folded += triple((cin, planes)) + triple((3, 3, planes, planes)) + triple((planes, cout))
            if kind == "ds":
                folded += triple((cin, cout))
            cin = cout
        x = randn(shape, 301, torch.float32, relu=False)
        got = flat(x, folded, blocks, band=band)
        want = fused_resnet_kernel.fused_chain_flat_plain(x, folded, blocks, band=band)
        same = torch.equal(got, chain(x, folded, blocks))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst32 = max(worst32, err)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
        plan = fused_resnet_kernel.flat_card_plan(x, folded, blocks, band)
        log(f"kernel fused_chain_flat {blocks} {list(shape)} band {band} f32 (th {plan['th']}, "
            f"C = {plan['cluster']}, grid {plan['grid']}): max abs err {err:.3g} to plain (atol "
            f"2e-4, rtol 1e-3); equal to fused_chain bit for bit: {same}")
        if not same:
            raise AssertionError(f"fused_chain_flat {blocks} {shape}: differs from fused_chain")

    rows, worst = [], 0.0
    cases = [c for c in chain_cases(detector, emotion) if set(c[3]) <= {"ds", "id"}]
    for seed, (label, layer, chunk, blocks, shape, _) in enumerate(cases):
        x = randn(shape, 310 + seed)
        folded = {dt: [t for bi in chunk for t in layer[bi].folded(dt)]
                  for dt in (torch.float32, torch.bfloat16)}
        case = f"{label} {blocks} {list(shape)}"
        plan = fused_resnet_kernel.flat_card_plan(x, folded[torch.bfloat16], blocks)
        plan = {k: plan[k] for k in ("th", "nwork", "cluster", "grid", "max_active_clusters")}
        log(f"  fused_chain_flat {case} bf16: band height {plan['th']}, {plan['nwork']} bands, "
            f"C = {plan['cluster']}, grid {plan['grid']}; the card holds "
            f"{plan['max_active_clusters']} such clusters at once")

        def run(a, dt):
            return (flat(a, folded[dt], blocks),)

        def run_plain(a, dt):
            return (fused_resnet_kernel.fused_chain_flat_plain(a, folded[dt], blocks),)

        def launch(a, dt, cluster):
            th = fused_resnet_kernel.flat_card_plan(a, folded[dt], blocks)["th"]
            return (fused_resnet_kernel._fused_chain_flat_cuda(a, folded[dt], blocks,
                                                               cluster=cluster, th=th),)

        worst = max(worst, check_fused("fused_chain_flat", run, run_plain, x,
                                       dict(atol=2e-4, rtol=1e-3), case))
        x_cl = x.permute(0, 3, 1, 2)
        section = torch.nn.Sequential(*[layer[bi] for bi in chunk])
        with torch.inference_mode():
            out = run(x, torch.bfloat16)[0]
            same = (torch.equal(out, chain(x, folded[torch.bfloat16], blocks))
                    and torch.equal(run(x[:4].float(), torch.float32)[0],
                                    chain(x[:4].float(), folded[torch.float32], blocks)))
            if not same:
                raise AssertionError(f"fused_chain_flat {case}: differs from fused_chain")
            ms = median_ms(lambda: run(x, torch.bfloat16))
            chain_ms = median_ms(lambda: chain(x, folded[torch.bfloat16], blocks))
            plain = median_ms(lambda: run_plain(x, torch.bfloat16), runs=3, warmup=1)
            lib_ms = median_ms(lambda: section(x_cl))
            if plan["cluster"] > 1:
                plan.update(hold_cluster("fused_chain_flat", case, x, launch, plan))
        b_ms, b_by = bound_ms(*chain_work(x, folded[torch.bfloat16], blocks, out), "bf16")
        log(f"  fused_chain_flat {case} bf16: kernel {ms:.3f} ms, fused_chain {chain_ms:.3f} ms "
            f"(equal to it bit for bit in bf16 and f32), plain {plain:.3f} ms (median of 3), "
            f"unfused cuDNN section {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) (median of 50) "
            f"on {card}")
        rows.append({"case": label, "blocks": list(blocks), "shape": list(shape), "ms": ms,
                     "fused_chain_ms": chain_ms, "plain_ms": plain, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by, **plan})
    first = rows[0]
    return entry("fused_chain_flat", "fused_resnet.cu",
                 "avcer_tpu/ops/pallas/fused_resnet_kernel.py:507", max_abs_err=worst,
                 ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                 bound_by=first["bound_by"], library_ms=first["library_ms"],
                 shape=first["shape"], fused_chain_ms=first["fused_chain_ms"],
                 max_abs_err_f32=worst32, on_main_path=False, cases=rows)


def int8_modules(card: str) -> None:
    """The int8 products outside the kernels (library calls, as in the JAX
    package they are XLA ops): each Q module's time beside the bf16 module it
    replaces, at a shape of the main path. All three quantise their input
    (divide, round, clamp, cast), multiply through ``torch._int_mm`` (a conv
    over its input unfolded tap by tap in int8) and dequantise."""
    gen = torch.Generator().manual_seed(0)
    cases = [
        ("QConv 3x3 256 -> 256 (an SSH conv at scale 1)", layers.QConv(256, 256, 3, padding=1, bias=False),
         torch.nn.Conv2d(256, 256, 3, padding=1, bias=False), (DETECT_BATCH, 256, 45, 80)),
        ("QConv 1x1 256 -> 64 (detector layer1 conv1)", layers.QConv(256, 64, 1, bias=False),
         torch.nn.Conv2d(256, 64, 1, bias=False), (DETECT_BATCH, 256, 90, 160)),
        ("QConv1d k3 s2 512 -> 512 (extractor layer 1, 16 windows)", layers.QConv1d(512, 512, 3, 2),
         torch.nn.Conv1d(512, 512, 3, stride=2), (AUDIO_BATCH, 512, 12799)),
        ("QDense 1024 -> 4096 (encoder FFN, 16 windows)", layers.QDense(1024, 4096),
         torch.nn.Linear(1024, 4096), (AUDIO_BATCH, 199, 1024)),
    ]
    for label, q, exact, shape in cases:
        layers.seeded_init_(exact, gen)
        q.load_state_dict(exact.state_dict())
        layers.cast_compute(q, torch.bfloat16).cuda().eval()
        exact.to(torch.bfloat16).cuda().eval()
        x = randn(shape, 400, relu=False)
        if len(shape) == 4:
            x = x.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            with layers.calibrating(q):
                got = q(x)
            want = exact(x)
            rel = rel_l2(got, want)
            q_ms, e_ms = median_ms(lambda: q(x)), median_ms(lambda: exact(x))
        log(f"int8 module {label} {list(shape)}: {q_ms:.3f} ms (torch._int_mm route) vs bf16 "
            f"{e_ms:.3f} ms; relative L2 to the bf16 module {rel:.4f} (median of 50) on {card}")
        if not rel < 0.05:
            raise AssertionError(f"{label}: relative L2 {rel} to the exact module")


def phase_kernels(card: str, fused_pipe, int8_pipe) -> list[dict]:
    detector = fused_pipe.detect.inner.model
    emotion = fused_pipe.visual.static_model
    qdetector = int8_pipe.detect.inner.model
    qemotion = int8_pipe.visual.static_model
    return (kernels_nms_attention(card)
            + [kernels_fused_chain(card, detector, emotion), kernels_fused_ssh(card, detector),
               kernels_fused_chain(card, qdetector, qemotion, quant=True),
               kernels_fused_ssh(card, qdetector, quant=True),
               kernels_fused_chain_flat(card, detector, emotion)])


def seeded_detector(backbone: str, quant: bool, dtype: torch.dtype, device: str, **switches):
    """The detector ``build_pipeline`` makes from seed 0 (it is the first
    family the generator initialises), in ``dtype`` on ``device``."""
    model = RetinaFace(backbone=backbone, quant=quant, **switches)
    layers.seeded_init_(model, torch.Generator().manual_seed(0)).eval().requires_grad_(False)
    return layers.cast_compute(model, dtype).to(device)


def phase_kernels_mobilenet(card: str) -> list[dict]:
    """K4 in the mode the mobilenet detector gives it: C = 64, leaky 0.1,
    batch 128, bf16 and int8 (the int8 model's scales seeded on noise, as the
    detect stage seeds them at build)."""
    detector = seeded_detector(MNET, False, torch.bfloat16, DEVICE)
    qdetector = seeded_detector(MNET, True, torch.bfloat16, DEVICE)
    noise = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (2, 160, 160, 3), np.uint8))
    with torch.inference_mode(), layers.calibrating(qdetector):
        qdetector(retinaface_normalize(noise.to(DEVICE)))
    out = [kernels_fused_ssh(card, detector), kernels_fused_ssh(card, qdetector, quant=True)]
    depthwise_sections(card, detector)
    return out


def smoke_config(dtype: str, fused: bool = False, int8: bool = False,
                 wire: str = "i420") -> PipelineConfig:
    """``cli.run``'s configuration: the I420 wire format, ``--fused`` sets the
    seven fused switches, ``--serving_profile int8`` quantises all three
    stages and shares the audio extractor. ``wire="bgr"``: native frames
    uploaded and letterboxed on the card."""
    quant = "int8" if int8 else "none"
    return PipelineConfig(
        detector=DetectorConfig(batch_size=DETECT_BATCH, long_side=640, transfer_format=wire,
                                dtype=dtype, quant=quant, fused_layer1=fused, fused_tails=fused,
                                fused_entries=fused, fused_ssh=fused, fused_fpn=fused),
        visual=VisualConfig(batch_size=CNN_BATCH, dtype=dtype, quant=quant, fused=fused,
                            fused_entries=fused),
        audio=AudioConfig(batch_size=AUDIO_BATCH, dtype=dtype, quant=quant, shared_extractor=int8),
        weights_dir=os.path.join(ROOT, "build", "smoke_no_weights"),
        save_plot=False,
    )


def wavlm_config() -> PipelineConfig:
    """``smoke_config("bfloat16", fused=True)`` with WavLM-Large under the
    audio head (``cli.run --fused --audio_encoder wavlm-large``)."""
    cfg = smoke_config("bfloat16", True)
    return dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio, encoder="wavlm-large"))


def phase_wavlm(card: str, frames: np.ndarray, wav: np.ndarray, entry_: dict) -> None:
    """The fused main path with WavLM-Large (``wavlm_config``): warm-up (each
    new K2 call, the biased ones too, held against the plain version), three
    timed runs with 24 K2 launches an audio batch, and a profiled run whose
    K2 launches must all be biased (``profiled_run``). Sets ``entry_``'s
    (the ``mha_tc_bias`` kernels entry's) launches to a timed run's."""
    pipe = build(card, True, cfg=wavlm_config(), label="wavlm-large --fused")
    _, launches = phase_main(card, pipe, True, frames, wav, label="wavlm-large fused main path",
                             profile=True)
    entry_["launches"] = launches["mha"]
    del pipe
    torch.cuda.empty_cache()


def preset_config(profile: str, fused: bool = False) -> PipelineConfig:
    """What ``cli.run --serving_profile P [--fused]`` builds, without the plot
    and with a weights directory that holds no checkpoint."""
    cfg = cli.config_from_args(cli.parse_args(
        ["--serving_profile", profile] + (["--fused"] if fused else [])))
    return dataclasses.replace(cfg, weights_dir=os.path.join(ROOT, "build", "smoke_no_weights"),
                               save_plot=False)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-12))


def phase_reference(pipe, fused_pipe, frames: np.ndarray, wav: np.ndarray):
    """Each model on the card (bf16, CUDA kernels), unfused and fused, against
    the same seeded weights in f32 on the CPU (plain versions, unfused), one
    small input each. bf16 keeps 8 significant bits (2**-8 relative per
    rounding) and the errors of some 60 layers add up; a relative L2 error
    under 5 % passes, while a wrong kernel, layout or weight gives errors of
    order 100 %. Returns the f32 CPU pipeline."""
    from avcer_tpu_torch.ops.audio import feature_extractor_normalize
    from avcer_tpu_torch.ops.image import retinaface_normalize, vggface_normalize

    ref = build_pipeline(smoke_config("float32"), device="cpu", seed=0)
    dev = torch.device("cuda")
    with torch.inference_mode():
        x = torch.from_numpy(frames[:1])
        lb, _ = pipe.detect.inner.prepare_batch(frames[:1])
        det_cpu = ref.detect.model(retinaface_normalize(lb.cpu()))
        det_card = pipe.detect.inner.model(retinaface_normalize(lb))
        det_fused = fused_pipe.detect.inner.model(retinaface_normalize(lb))
        crop = x[:, 60:284, 200:424]  # a 224 x 224 crop
        emo_cpu = ref.visual.static_model(vggface_normalize(crop))
        emo_card = pipe.visual.static_model(vggface_normalize(crop.to(dev)))
        emo_fused = fused_pipe.visual.static_model(vggface_normalize(crop.to(dev)))
        win = torch.from_numpy(wav[None, :64000])
        aud_card = pipe.audio.model(feature_extractor_normalize(win.to(dev)))
        aud_cpu = ref.audio.model(feature_extractor_normalize(win))
    names = ("detector loc", "detector conf", "detector landmarks", "emotion logits",
             "emotion features")
    cpu = (*det_cpu, *emo_cpu)
    errs = {n: rel_l2(g, w) for n, g, w in zip(names, (*det_card, *emo_card), cpu)}
    errs["audio logits"] = rel_l2(aud_card, aud_cpu)
    errs.update({f"fused {n}": rel_l2(g, w) for n, g, w in zip(names, (*det_fused, *emo_fused), cpu)})
    log("reference (card bf16 vs CPU f32, relative L2): "
        + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()))
    log("fused vs unfused on the card (bf16, relative L2): " + ", ".join(
        f"{n} {rel_l2(g, w):.4f}" for n, g, w in zip(names, (*det_fused, *emo_fused),
                                                     (*det_card, *emo_card))))
    bad = {k: v for k, v in errs.items() if not v < 0.05}
    if bad:
        raise AssertionError(f"card outputs disagree with the f32 CPU reference: {bad}")
    return ref


def phase_reference_int8(int8_pipe, int8_fused_pipe, frames: np.ndarray, wav: np.ndarray) -> None:
    """The int8 detector, emotion CNN and audio model on the card (bf16
    between the int8 products, kernels), unfused and fused, against the same
    modules in f32 compute dtype on the CPU (plain versions) with the same
    weights and the same activation scales, one small input each. On top of
    bf16's roundings, a value that bf16 moves across a quantisation boundary
    lands one step away (amax / 127), in every conv: a relative L2 error
    under 10 % passes; a wrong scale order, fold or kernel gives tens of
    percent and more."""
    from avcer_tpu_torch.ops.audio import feature_extractor_normalize
    from avcer_tpu_torch.ops.image import retinaface_normalize, vggface_normalize

    ref = build_pipeline(smoke_config("float32", int8=True), device="cpu", seed=0)
    dev = torch.device("cuda")
    pairs = ((ref.detect.model, int8_pipe.detect.inner.model, int8_fused_pipe.detect.inner.model),
             (ref.visual.static_model, int8_pipe.visual.static_model,
              int8_fused_pipe.visual.static_model),
             (ref.audio.model, int8_pipe.audio.model, int8_fused_pipe.audio.model))
    for cpu_model, card_model, fused_model in pairs:
        scales = {k: v.cpu() for k, v in layers.act_scales(card_model).items()}
        layers.load_act_scales(cpu_model, scales)
        layers.load_act_scales(fused_model, {k: v.to(dev) for k, v in scales.items()})
    with torch.inference_mode():
        x = torch.from_numpy(frames[:1])
        lb, _ = int8_pipe.detect.inner.prepare_batch(frames[:1])
        det_cpu = pairs[0][0](retinaface_normalize(lb.cpu()))
        det_card = pairs[0][1](retinaface_normalize(lb))
        det_fused = pairs[0][2](retinaface_normalize(lb))
        crop = x[:, 60:284, 200:424]
        emo_cpu = pairs[1][0](vggface_normalize(crop))
        emo_card = pairs[1][1](vggface_normalize(crop.to(dev)))
        emo_fused = pairs[1][2](vggface_normalize(crop.to(dev)))
        win = torch.from_numpy(wav[None, :64000])
        aud_cpu = pairs[2][0](feature_extractor_normalize(win))
        aud_card = pairs[2][1](feature_extractor_normalize(win.to(dev)))
    names = ("detector loc", "detector conf", "detector landmarks", "emotion logits",
             "emotion features")
    cpu = (*det_cpu, *emo_cpu)
    errs = {n: rel_l2(g, w) for n, g, w in zip(names, (*det_card, *emo_card), cpu)}
    errs["audio logits"] = rel_l2(aud_card, aud_cpu)
    errs.update({f"fused {n}": rel_l2(g, w) for n, g, w in zip(names, (*det_fused, *emo_fused), cpu)})
    log("int8 reference (card, bf16 between int8 products, vs CPU, f32 between them; same "
        "scales; relative L2): " + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()))
    log("int8 fused vs int8 unfused on the card (relative L2): " + ", ".join(
        f"{n} {rel_l2(g, w):.4f}" for n, g, w in zip(names, (*det_fused, *emo_fused),
                                                     (*det_card, *emo_card))))
    bad = {k: v for k, v in errs.items() if not v < 0.10}
    if bad:
        raise AssertionError(f"int8 card outputs disagree with the f32 CPU int8 reference: {bad}")


def phase_reference_mobilenet(served, frames: np.ndarray) -> None:
    """The mobilenet0.25 detector on the card (bf16, kernels), unfused and
    with ``fused_ssh + fused_fpn``, exact and int8, against the same seeded
    weights in f32 on the CPU (plain versions, unfused), on two frames
    letterboxed to the 448 bucket. ``served``: the ``turbo`` pipeline's
    detector after its runs, whose calibrated scales all three int8 models
    take. Bounds as for the r50 detector: relative L2 under 5 % exact, under
    10 % int8."""
    dev = torch.device(DEVICE)
    first = served.body.stage1[0][0].weight
    probe = seeded_detector(MNET, True, first.dtype, DEVICE)
    if not torch.equal(probe.body.stage1[0][0].weight, first):
        raise AssertionError("seeded_detector does not reproduce build_pipeline's detector")
    scales = layers.act_scales(served)
    with torch.inference_mode():
        lb = resize_bilinear_uint8(torch.from_numpy(frames[:2]).to(dev), 252, 448)
        x = retinaface_normalize(lb)
        errs, outs = {}, {}
        for quant in (False, True):
            cpu = seeded_detector(MNET, quant, torch.float32, "cpu")
            if quant:
                layers.load_act_scales(cpu, {k: v.cpu() for k, v in scales.items()})
            want = cpu(x.cpu())
            for fused in (False, True):
                switches = dict(fused_ssh=True, fused_fpn=True) if fused else {}
                model = seeded_detector(MNET, quant, torch.bfloat16, DEVICE, **switches)
                if quant:
                    layers.load_act_scales(model, scales)
                before = fused_ssh_kernel.fused_ssh_heads.launches
                got = model(x)
                torch.cuda.synchronize()
                if fused_ssh_kernel.fused_ssh_heads.launches - before != (3 if fused else 0):
                    raise AssertionError("the mobilenet detector's fused forward did not launch "
                                         "fused_ssh_heads three times")
                key = ("int8 " if quant else "") + ("fused" if fused else "unfused")
                outs[key] = got
                for name, g, w in zip(("loc", "conf", "landmarks"), got, want):
                    errs[f"{key} {name}"] = rel_l2(g, w)
    log("mobilenet reference (card bf16 vs CPU f32; int8: the same scales; relative L2): "
        + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()))
    for q in ("", "int8 "):
        log(f"mobilenet {q}fused vs {q}unfused on the card (relative L2): " + ", ".join(
            f"{n} {rel_l2(g, w):.4f}" for n, g, w in zip(
                ("loc", "conf", "landmarks"), outs[q + "fused"], outs[q + "unfused"])))
    bad = {k: v for k, v in errs.items() if not v < (0.10 if k.startswith("int8") else 0.05)}
    if bad:
        raise AssertionError(f"mobilenet card outputs disagree with the f32 CPU reference: {bad}")


class ForceTopFace:
    """The real detect stage, in full, but each detected frame's top candidate
    is its one face: with random weights nothing scores like a face, and yet
    up to 64 candidates pass the 0.8 threshold, which no real clip has and
    which makes the host tracker (O(N*M) Python per frame) the whole wall time.
    A face does not jump: where the top candidate is no valid box, or overlaps
    the previous frame's face by less than half (random weights put it
    anywhere), the previous face stays, so that the tracker keeps its target
    through the clip. ``raw_kept`` counts the candidates the detector itself
    kept. With a detect stride the rows are the detected frames'. The previous
    face is kept per thread and dropped by ``start_clip`` (``run_many`` serves
    one clip per thread at a time)."""

    def __init__(self, inner, h: int, w: int):
        self.inner, self.h, self.w = inner, h, w
        self.raw_kept = 0
        self.frames = 0
        self._clip = threading.local()

    def start_clip(self) -> None:
        self._clip.face = None

    def dispatch(self, frames):
        return self.inner.dispatch(frames)

    def prepare_wire(self, frames):
        return self.inner.prepare_wire(frames)

    def dispatch_wire(self, wire, scale):
        return self.inner.dispatch_wire(wire, scale)

    def unpack(self, packed_np, scale):
        det = self.inner.unpack(packed_np, scale)
        self.raw_kept += int(det.keep.sum())
        self.frames += det.keep.shape[0]
        det.keep = np.zeros_like(det.keep)
        det.keep[:, 0] = True
        det.scores = np.array(det.scores)
        det.scores[:, 0] = np.maximum(det.scores[:, 0], 0.9)
        det.boxes = np.array(det.boxes)
        face = getattr(self._clip, "face", None)
        for i in range(det.boxes.shape[0]):
            x1, y1, x2, y2 = box = det.boxes[i, 0].copy()
            valid = (0 <= x1 < x2 <= self.w and 0 <= y1 < y2 <= self.h
                     and x2 - x1 > 8 and y2 - y1 > 8)
            if face is None:
                face = box if valid else np.array(
                    [self.w * 0.25, self.h * 0.25, self.w * 0.75, self.h * 0.75], box.dtype)
            elif valid:
                iw = min(x2, face[2]) - max(x1, face[0])
                ih = min(y2, face[3]) - max(y1, face[1])
                inter = max(iw, 0.0) * max(ih, 0.0)
                union = (x2 - x1) * (y2 - y1) + (face[2] - face[0]) * (face[3] - face[1]) - inter
                if inter >= 0.5 * union:
                    face = box
            det.boxes[i, 0] = face
        self._clip.face = face
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


def build(card: str, fused: bool, int8: bool = False, cfg: PipelineConfig | None = None,
          label: str = "", mesh_devices: list | None = None):
    t0 = time.perf_counter()
    int8 = int8 if cfg is None else cfg.visual.quant == "int8"
    pipe = build_pipeline(cfg or smoke_config("bfloat16", fused, int8), device=DEVICE, seed=0,
                          mesh_devices=mesh_devices)
    pipe.detect = ForceTopFace(pipe.detect, HEIGHT, WIDTH)
    run = pipe.run

    def run_clip(video, *args, **kwargs):  # also what run_many calls, once a clip
        pipe.detect.start_clip()
        return run(video, *args, **kwargs)

    pipe.run = run_clip
    torch.cuda.synchronize()
    log(f"build_pipeline ({label or f'fused={fused}, int8={int8}'}: full width, seeded init, bf16"
        f"{', scales seeded on noise: one calibration forward a stage' if int8 else ''}): "
        f"{time.perf_counter() - t0:.2f} s")
    return pipe


def calibration_forwards(pipe) -> dict[str, int]:
    return {"detect": pipe.detect.inner.calibration_forwards,
            "visual": pipe.visual.calibration_forwards,
            "audio": pipe.audio.calibration_forwards}


def phase_main(card: str, pipe, fused: bool, frames: np.ndarray, wav: np.ndarray,
               int8: bool = False, label: str = "", timed_runs: int = TIMED_RUNS,
               profile: bool = False):
    """One warm-up run and ``timed_runs`` timed runs of one pipeline. Every
    count is set to 0 just before a timed run and read just after it. In int8
    the warm-up run refines the noise-seeded scales on the clip's first frames,
    crops and windows (one calibration forward a stage, counted apart); the
    timed runs must then all run with the same frozen scales. With
    ``profile``, one more run under the CLI's ``--profile_dir`` helper gives
    the device's busy and idle share of the wall. Returns the last timed run's
    result and launch counts."""
    label = label or ("int8 " if int8 else "") + ("fused main path" if fused else "main path")
    cnn_calls, crops_asked = [0], [0]
    hook = pipe.visual.static_model.register_forward_hook(
        lambda *_: cnn_calls.__setitem__(0, cnn_calls[0] + 1))
    run_static = pipe.visual.run_static_from_frames

    def counted_run_static(frames_dev, present_idx, boxes):
        crops_asked[0] += len(present_idx)
        return run_static(frames_dev, present_idx, boxes)

    pipe.visual.run_static_from_frames = counted_run_static
    t0 = time.perf_counter()
    with holding_new_calls():
        pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    torch.cuda.synchronize()
    log(f"{label} warm-up run (new kernel calls held against their plain versions): "
        f"{time.perf_counter() - t0:.2f} s")
    if int8:
        calib = calibration_forwards(pipe)
        log(f"{label}: calibration forwards so far (seed at build + refinement in the warm-up "
            f"run), outside the timed runs: {calib}")
        if set(calib.values()) != {2}:
            raise AssertionError(f"{label}: expected 2 calibration forwards a stage, got {calib}")

    walls = []
    packs = fused_resnet_kernel.pack_chain_q.calls  # int8 weights packed at fold time only
    for run in range(1, timed_runs + 1):
        reset_counts()
        cnn_calls[0] = crops_asked[0] = 0
        pipe.detect.raw_kept = pipe.detect.frames = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = counts()
        check_main_path(clip, frames.shape[0], launches, pipe.cfg, cnn_calls[0], crops_asked[0])
        if int8 and calibration_forwards(pipe) != calib:
            raise AssertionError(f"{label}: the scales moved in a timed run: "
                                 f"{calibration_forwards(pipe)}")
        if fused_resnet_kernel.pack_chain_q.calls != packs:
            raise AssertionError(f"{label}: a timed run packed int8 weights again "
                                 f"({fused_resnet_kernel.pack_chain_q.calls - packs} calls)")
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in clip.timings.items())
        log(f"{label} timed run {run}: {stages} on {card}")
    PATH_LAUNCHES[label] = launches
    hook.remove()
    pipe.visual.run_static_from_frames = run_static
    log(f"detector kept {pipe.detect.raw_kept / max(pipe.detect.frames, 1):.1f} candidates "
        "per detected frame before the top one was forced to be the only face")
    wall = float(np.median(walls))
    if profile:
        profiled_run(card, pipe, frames, wav, label, wall, launches)
    log(f"{label}: {frames.shape[0]} frames ({CLIP_SECONDS} s of video), wall per run "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, median {wall:.3f} s = "
        f"{CLIP_SECONDS / wall:.3f} video-sec/sec on {card}; launches per run {launches}, "
        f"fused_ssh_heads launches by leaky slope "
        f"{fused_ssh_kernel.fused_ssh_heads.launches_by_leaky}, emotion CNN forward calls "
        f"{cnn_calls[0]} for {crops_asked[0]} crops")
    return clip, launches


def kernels_i420(card: str, frames: np.ndarray) -> dict:
    """The I420 rebuild (``i420_to_bgr``, no TPU kernel: XLA in the JAX
    package) against its plain version at the main paths' wires
    (``I420_BUCKETS``, letterboxed with cv2 and converted as ``prepare_wire``
    does), on the clip's frames and on uniformly random bytes of the same
    shape (every clamp and rounding): equal bit for bit. Its time a call
    (CUDA events, median of 50) and device time (profiler, 20 calls) beside
    the plain version's and the bytes bound (1.5 bytes a pixel read, 3
    written, once; some 10 f32 operations a pixel)."""
    import cv2
    from avcer_tpu_torch.ops.image import bgr_batch_to_i420, letterbox_params

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    cases = []
    for b, long_side in I420_BUCKETS:
        batch = frames[np.arange(b) % len(frames)]
        h, w, _ = letterbox_params(HEIGHT, WIDTH, long_side)
        if (h, w) != (HEIGHT, WIDTH):
            batch = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                              for f in batch])
        wire = torch.from_numpy(bgr_batch_to_i420(batch)).to(dev)
        noise = torch.from_numpy(rng.integers(0, 256, tuple(wire.shape), np.uint8)).to(dev)
        mismatches = 0
        for x in (wire, noise):
            got = image_kernel.i420_to_bgr(x, h, w)
            want = image_kernel.i420_to_bgr_plain(x, h, w)
            torch.cuda.synchronize()
            mismatches += int((got != want).sum())
        if mismatches:
            raise AssertionError(f"i420_to_bgr: {mismatches} values differ from the plain "
                                 f"version at [{b}, {h}, {w}]")
        ms = median_ms(lambda: image_kernel.i420_to_bgr(wire, h, w))
        plain_ms = median_ms(lambda: image_kernel.i420_to_bgr_plain(wire, h, w))
        dev_ms = device_ms(lambda: image_kernel.i420_to_bgr(wire, h, w))
        nbytes = tensor_bytes(wire, got)
        bound, by = bound_ms(nbytes, 10.0 * b * h * w, "f32")
        cases.append(dict(shape=[b, h, w], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                          device_ms=dev_ms, bound_ms=bound, bound_by=by, mbytes=nbytes / 1e6))
        log(f"kernel i420_to_bgr (i420_to_bgr_kernel) [{b}, {h * 3 // 2}, {w}] -> [{b}, {h}, {w}, "
            f"3]: equal bit for bit to the plain version on the clip's wire and on random bytes; "
            f"{ms:.4f} ms a call (median of 50), device time {ms_text(dev_ms)} (profiler, 20 "
            f"calls), vs plain {plain_ms:.4f} ms; {nbytes / 1e6:.1f} MB, bound {bound:.4f} ms "
            f"({by}), no library call, on {card}")
    return entry("i420_to_bgr", "image.cu", "avcer_tpu/ops/image.py:217", library_ms=None,
                 **cases[0], cases=cases[1:],
                 replaces_what="i420_to_bgr_device: XLA in the JAX detect program, not Pallas")


def phase_wire_formats(card: str, pipe, frames: np.ndarray, wav: np.ndarray, clip) -> None:
    """``parity`` on both wire formats in this one call: ``pipe`` on I420 (the
    default) and a second pipeline of the same seeded weights on ``bgr`` (a
    warm-up run with its new kernel calls held and one checked run), then
    three runs of each in turns, I420 first. Prints both medians with their
    ranges, the share of the clip's BGR values the I420 round trip changes,
    and the two runs' decisions side by side (other pixels: reported)."""
    from avcer_tpu_torch.ops.image import bgr_batch_to_i420

    bgr = build(card, False, cfg=smoke_config("bfloat16", wire="bgr"), label="parity, bgr wire")
    bgr_clip, _ = phase_main(card, bgr, False, frames, wav, label="bgr main path", timed_runs=1)
    walls: dict[str, list] = {"i420": [], "bgr": []}
    for _ in range(TIMED_RUNS):
        for name, p in (("i420", pipe), ("bgr", bgr)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    for name, w in walls.items():
        log(f"parity on the {name} wire, {TIMED_RUNS} runs in turns with the other format: "
            f"{', '.join(f'{x:.4f}' for x in w)} s, median {float(np.median(w)):.4f} s (range "
            f"{min(w):.4f}-{max(w):.4f}) on {card}")
    first = frames[:DETECT_BATCH]
    rebuilt = image_kernel.i420_to_bgr(
        torch.from_numpy(bgr_batch_to_i420(first)).to(DEVICE), HEIGHT, WIDTH).cpu().numpy()
    moved = np.abs(rebuilt.astype(np.int32) - first.astype(np.int32))
    log(f"the I420 round trip changes {(moved > 0).mean():.1%} of the first batch's BGR values "
        f"(largest change {moved.max()}, mean {moved.mean():.2f})")
    agreement(clip, bgr_clip, "parity on the i420 wire vs the bgr wire", 0.0)
    del bgr
    torch.cuda.empty_cache()


def phase_plain_route(pipe, frames: np.ndarray, wav: np.ndarray, want, label: str) -> None:
    """One run of ``pipe`` with the I420 rebuild on its plain PyTorch version
    on the card (every other module as served) against the same pipeline's
    last timed run on the kernel: detections, probabilities and compound
    decisions equal (the kernel equals its plain version bit for bit, and the
    int8 scales are frozen after the warm-up run)."""
    before = image_kernel.i420_to_bgr.launches
    detect_module.i420_to_bgr = image_kernel.i420_to_bgr_plain
    try:
        got = pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    finally:
        detect_module.i420_to_bgr = image_kernel.i420_to_bgr
    if image_kernel.i420_to_bgr.launches != before:
        raise AssertionError(f"{label}: the plain route launched the kernel")
    same_results(got, want, f"{label} with the I420 rebuild on its plain version vs the kernel")


def phase_calibrate(card: str, frames: np.ndarray, wav: np.ndarray, default_clip) -> dict:
    """``cli.run --calibrate``: ``parity`` built with ``calibrate=True``, its
    cache file a temporary one (``calibrate.DEFAULT_CACHE`` pointed at it):
    every CNN (64-512) and audio (8-32) candidate timed on the card and the
    fastest applied; a second calibration of the same pipeline, with
    disjoint candidates, hits the cache and times nothing; then the
    calibrated batches' run (after a warm-up run with its new kernel calls
    held) against ``default_clip``, the default batches' (256 crops, 16
    windows): the same boxes, the probabilities within ``CALIB_PROB_TOL``
    and the compound decisions on ``CALIB_AGREE`` of the frames (equal where
    the calibration kept the defaults). Returns the record."""
    import tempfile

    from avcer_tpu_torch.pipeline import calibrate as calibrate_module

    cache_dir = tempfile.mkdtemp(prefix="smoke_calibration_")
    cache = os.path.join(cache_dir, "calibration.json")
    timed: list = []
    inner, default_cache = calibrate_module._time_slope, calibrate_module.DEFAULT_CACHE

    def counted(*args, **kw):
        timed.append(1)
        return inner(*args, **kw)

    calibrate_module._time_slope, calibrate_module.DEFAULT_CACHE = counted, cache
    try:
        t0 = time.perf_counter()
        cpipe = build(card, False, cfg=dataclasses.replace(smoke_config("bfloat16"),
                                                           calibrate=True),
                      label="parity --calibrate")
        build_s = time.perf_counter() - t0
        measured = len(timed)
        with open(cache) as f:
            record = json.load(f)[calibrate_module._cache_key(cpipe)]
        t0 = time.perf_counter()
        again = calibrate_module.calibrate(cpipe, cache, cnn_batches=(999,), audio_batches=(999,))
        hit_s = time.perf_counter() - t0
        hit_timed = len(timed) - measured
    finally:
        calibrate_module._time_slope, calibrate_module.DEFAULT_CACHE = inner, default_cache
        shutil.rmtree(cache_dir, ignore_errors=True)
    log(f"--calibrate on {card}: key {calibrate_module._cache_key(cpipe)!r}; crop-CNN ms a frame "
        f"{record['cnn_ms_per_frame']}, audio ms a window {record['audio_ms_per_window']}; "
        f"chosen: CNN batch {record['visual_batch']}, audio batch {record['audio_batch']}; the "
        f"build with the calibration {build_s:.2f} s")
    log(f"--calibrate again on the same pipeline: {hit_timed} candidates timed, {hit_s * 1e3:.2f} "
        f"ms, the cached record {'returned' if again == record else 'NOT returned'}")
    with holding_new_calls():
        cpipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = cpipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    defaults = (record["visual_batch"], record["audio_batch"]) == (CNN_BATCH, AUDIO_BATCH)

    def softmax(x):
        e = np.exp(x - x.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    stat_diff = float(np.abs(got.stat_probs - default_clip.stat_probs).max())
    audio_diff = float(np.abs(softmax(got.audio_window_logits)
                              - softmax(default_clip.audio_window_logits)).max())
    agree = float((got.compound.av == default_clip.compound.av).mean())
    n = len(got.compound.av)
    log(f"parity at the calibrated batches ({record['visual_batch']} crops, "
        f"{record['audio_batch']} windows) vs the defaults ({CNN_BATCH}, {AUDIO_BATCH}): wall "
        f"{wall:.4f} s; compound decisions equal on {int(round(agree * n))} of {n} frames; "
        f"largest probability difference static {stat_diff:.3g}, audio {audio_diff:.3g} "
        f"(tolerance {'0: the defaults were kept' if defaults else CALIB_PROB_TOL}, decisions "
        f"{'all' if defaults else f'{CALIB_AGREE:.0%}'}) on {card}")
    checks = {
        "7 candidates timed (4 CNN, 3 audio)": measured == 7,
        "the second call timed nothing and returned the cached record":
            hit_timed == 0 and again == record,
        "the record applied": (cpipe.visual.batch_size, cpipe.audio.cfg.batch_size)
            == (record["visual_batch"], record["audio_batch"]),
        "the same face boxes": np.array_equal(got.face_boxes, default_clip.face_boxes),
        "probabilities and decisions within the tolerance":
            (stat_diff == audio_diff == 0.0 and agree == 1.0) if defaults else
            (max(stat_diff, audio_diff) <= CALIB_PROB_TOL and agree >= CALIB_AGREE),
    }
    for name, ok in checks.items():
        log(f"  check --calibrate: {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"--calibrate: checks failed; record {record}")
    del cpipe
    torch.cuda.empty_cache()
    return record


BUILD_CACHE_CHILD = """
import time
T0 = time.perf_counter()
import json
import sys
sys.path.insert(0, {root!r})
import torch
from avcer_tpu_torch import _build
from avcer_tpu_torch.ops.cuda import image_kernel
from avcer_tpu_torch.pipeline import detect
first = {{}}
library = _build.library
def loading(name):
    first.setdefault("library", time.perf_counter() - T0)
    return library(name)
_build.library = loading
def rebuilt(*args, **kw):
    out = image_kernel.i420_to_bgr(*args, **kw)
    if "launch" not in first:
        torch.cuda.synchronize()
        first["launch"] = time.perf_counter() - T0
    return out
detect.i420_to_bgr = rebuilt
from avcer_tpu_torch.cli import run as cli
rc = cli.main({argv!r})
print(json.dumps({{"rc": rc, "compiles": _build.compiles, "loaded": sorted(_build._libs),
                  "dir": str(_build.build_dir()), "first_library_s": first.get("library"),
                  "first_launch_s": first.get("launch"), "wall_s": time.perf_counter() - T0}}))
"""


def phase_build_cache(card: str, frames: np.ndarray, wav: np.ndarray) -> dict:
    """``--compile_cache_dir``: the libraries this process built, copied into
    a temporary directory; a fresh process serves ``cli.run --fused
    --compile_cache_dir DIR`` on a 2 s clip (``parity``, seeded weights): it
    loads every kernel from DIR with no nvcc build (``_build.compiles`` 0;
    only ``nvcc --version`` runs, the toolkit's part of the hash), and
    prints its time from its start to its first library load and to the end
    of its first kernel launch (the I420 rebuild of the first detect
    batch)."""
    import tempfile

    cache = tempfile.mkdtemp(prefix="smoke_kernel_cache_")
    root = os.path.join(ROOT, "build", "smoke_build_cache")
    if os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(root)
    try:
        for name in _build.KERNELS:
            shutil.copy2(_build.library_path(name), cache)
        clip = os.path.join(root, "clip.avi")
        write_video(clip, frames[:2 * FPS])
        write_wav(os.path.join(root, "clip.wav"), wav[:2 * 16000], 16000)
        argv = ["--path_video", clip, "--path_save", os.path.join(root, "out"), "--fused",
                "--weights_dir", os.path.join(ROOT, "build", "smoke_no_weights"),
                "--compile_cache_dir", cache]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", BUILD_CACHE_CHILD.format(root=ROOT,
                                                                             argv=argv)],
                              capture_output=True, text=True, timeout=600, cwd=ROOT)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        got = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    checks = {
        "the fresh process exited 0": proc.returncode == 0 and got.get("rc") == 0,
        "no nvcc build": got.get("compiles") == 0,
        f"every kernel loaded ({', '.join(_build.KERNELS)})":
            got.get("loaded") == sorted(_build.KERNELS),
        "from the copied directory": got.get("dir") == cache,
        "a kernel launched": got.get("first_launch_s") is not None,
    }
    for name, ok in checks.items():
        log(f"  check --compile_cache_dir: {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"--compile_cache_dir: checks failed: {got}; stderr "
                             f"{proc.stderr[-3000:]}")
    log(f"--compile_cache_dir (warm, a fresh process): first library loaded "
        f"{got['first_library_s']:.2f} s after its start, first kernel launch done "
        f"{got['first_launch_s']:.2f} s, the whole cli.run {got['wall_s']:.2f} s ({wall:.2f} s "
        f"with the interpreter's start), 0 nvcc builds, on {card}")
    return got



def reset_counts() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    nms_kernel.nms_mask.launches_by_mode.update({True: 0, False: 0})
    fused_ssh_kernel.fused_ssh_heads.launches_by_leaky.clear()
    attention_kernel.mha.launches_by_kernel.update(tc=0, exact=0)


def counts() -> dict[str, int]:
    """Each wrapper's launches, and the attention launches by kernel."""
    out = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    out.update({f"mha_{k}": n for k, n in attention_kernel.mha.launches_by_kernel.items()})
    return out


def profiled_run(card: str, pipe, frames: np.ndarray, wav: np.ndarray, label: str,
                 wall: float, launches: dict[str, int]) -> None:
    """One run under ``cli.profiled`` (what ``cli.run --profile_dir`` does):
    the union of the device's kernel, copy and set intervals in the Chrome
    trace over the run's wall (which the profiler lengthens on the host) and
    over the timed runs' median wall, and the kernels that took the most
    device time. Every NMS kernel in the trace must be the bitmask kernel,
    as many as a timed run's ``nms_launches``; K3's kernel (``chain_kernel``)
    must appear ``chain_launches`` times, as in a timed run, and its device
    time and share of the busy time are reported, K4's (``ssh_kernel``) as
    often as a timed run launched it, likewise; the I420 rebuild's kernel
    (``i420_to_bgr_kernel``) as often as a timed run launched it, with its
    device time; the run must pack no int8 weights. Every detect batch of
    the run must replay its piecewise graphs (captured in the warm-up run),
    as the timed runs do: the clip's ``detect.graph_*`` counters. With
    WavLM-Large the launch counts are zeroed just before the run: every K2
    launch of the run (as many as in a timed run, 24 an audio batch) must be
    biased, by the clip's ``k2.calls`` and ``k2.bias_calls`` counters and by
    the trace's kernels (``mha_tc_bias_kernel`` each, no unbiased
    ``mha_tc_kernel``), with their device time. ``launches``: a timed run's."""
    nms_launches, chain_launches = launches["nms_mask"], launches["fused_chain"]
    path = os.path.join(ROOT, "build", "smoke_traces", label.replace(" ", "_").strip("-_"))
    wavlm = pipe.cfg.audio.encoder == "wavlm-large"
    torch.cuda.synchronize()
    packs = fused_resnet_kernel.pack_chain_q.calls
    if wavlm:
        reset_counts()
    t0 = time.perf_counter()
    with cli.profiled(path, DEVICE):
        pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
        torch.cuda.synchronize()
    run_wall = time.perf_counter() - t0
    k2_counts = {k: n for k, n in trace.clips()[-1].counts.items() if k.startswith("k2.")}
    if wavlm and (counts()["mha"], k2_counts) != (
            launches["mha"], {"k2.calls": launches["mha"], "k2.bias_calls": launches["mha"]}):
        raise AssertionError(f"{label}: K2 launches {counts()['mha']} and counters {k2_counts} "
                             f"under the profiler, {launches['mha']} biased a timed run")
    if fused_resnet_kernel.pack_chain_q.calls != packs:
        raise AssertionError(f"{label}: the profiled run packed int8 weights again")
    routes = {k: n for k, n in trace.clips()[-1].counts.items() if k.startswith("detect.graph_")}
    log(f"{label} under the profiler: detect batches by route {routes} ({nms_launches} detect "
        "batches a timed run)")
    if routes != {"detect.graph_replays": nms_launches}:
        raise AssertionError(f"{label}: detect batches by route {routes}, expected "
                             f"{nms_launches} replays of the piecewise graphs")
    with open(os.path.join(path, cli.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not any(e["cat"] == "kernel" for e in events):
        raise AssertionError(f"{label}: the profiler's trace holds no device kernel")
    nms = [e["name"] for e in events if e["cat"] == "kernel" and re.search(r"nms\w*_kernel",
                                                                             e["name"])]
    log(f"{label} under the profiler: {len(nms)} NMS kernels in the trace, "
        f"{sum('nms_bitmask_kernel' in n for n in nms)} of them nms_bitmask_kernel "
        f"({nms_launches} launches a timed run)")
    if len(nms) != nms_launches or not all("nms_bitmask_kernel" in n for n in nms):
        raise AssertionError(f"{label}: NMS kernels in the trace {sorted(set(nms))} x {len(nms)}, "
                             f"expected nms_bitmask_kernel x {nms_launches}")
    busy, end = 0.0, -np.inf
    for start, dur in sorted((float(e["ts"]), float(e["dur"])) for e in events):
        busy += max(0.0, start + dur - max(start, end))
        end = max(end, start + dur)
    busy *= 1e-6  # the trace counts microseconds
    by_name: dict[str, list] = {}
    for e in events:
        rec = by_name.setdefault(e["name"][:60], [0.0, 0])
        rec[0] += float(e["dur"]) * 1e-3
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"{label} under the profiler (cli.profiled, CPU + CUDA): device busy {busy:.4f} s of "
        f"the run's {run_wall:.4f} s wall = {busy / run_wall:.1%} busy, {1 - busy / run_wall:.1%} "
        f"idle; of the timed runs' median wall {wall:.4f} s: {busy / wall:.1%} busy, "
        f"{1 - busy / wall:.1%} idle; {len(events)} device events on {card}")
    log(f"{label} device time by kernel (ms, launches): "
        + "; ".join(f"{name} {ms:.3f}, {n}" for name, (ms, n) in top))
    chain = [float(e["dur"]) * 1e-3 for e in events if e["cat"] == "kernel"
             and "chain_kernel" in e["name"] and "chain_flat_kernel" not in e["name"]]
    log(f"{label} under the profiler: K3 (chain_kernel) {len(chain)} launches "
        f"({chain_launches} a timed run), {sum(chain):.3f} ms of device time = "
        f"{sum(chain) * 1e-3 / busy:.1%} of the busy time; no int8 weights packed in the run")
    if len(chain) != chain_launches:
        raise AssertionError(f"{label}: {len(chain)} chain_kernel launches in the trace, "
                             f"{chain_launches} in a timed run")
    ssh = [float(e["dur"]) * 1e-3 for e in events if e["cat"] == "kernel"
           and "ssh_kernel" in e["name"]]
    log(f"{label} under the profiler: K4 (ssh_kernel) {len(ssh)} launches "
        f"({launches['fused_ssh_heads']} a timed run), {sum(ssh):.3f} ms of device time = "
        f"{sum(ssh) * 1e-3 / busy:.1%} of the busy time")
    if len(ssh) != launches["fused_ssh_heads"]:
        raise AssertionError(f"{label}: {len(ssh)} ssh_kernel launches in the trace, "
                             f"{launches['fused_ssh_heads']} in a timed run")
    i420 = [float(e["dur"]) * 1e-3 for e in events if e["cat"] == "kernel"
            and "i420_to_bgr_kernel" in e["name"]]
    log(f"{label} under the profiler: i420_to_bgr_kernel {len(i420)} launches "
        f"({launches['i420_to_bgr']} a timed run), {sum(i420):.4f} ms of device time "
        f"({sum(i420) / max(len(i420), 1):.4f} ms each) = {sum(i420) * 1e-3 / busy:.2%} of the "
        "busy time")
    if i420:
        I420_TRACED[label] = sum(i420) / len(i420)
    if len(i420) != launches["i420_to_bgr"]:
        raise AssertionError(f"{label}: {len(i420)} i420_to_bgr_kernel launches in the trace, "
                             f"{launches['i420_to_bgr']} in a timed run")
    if wavlm:
        k2 = {kind: [float(e["dur"]) * 1e-3 for e in events if e["cat"] == "kernel"
                     and re.search(rf"\bmha_{kind}_kernel\b", e["name"])]
              for kind in ("tc", "tc_bias")}
        biased = sum(k2["tc_bias"])
        log(f"{label} under the profiler: counters {k2_counts}; mha_tc_bias_kernel "
            f"{len(k2['tc_bias'])} launches ({launches['mha']} a timed run), {biased:.3f} ms of "
            f"device time ({biased / max(len(k2['tc_bias']), 1):.4f} ms each) = "
            f"{biased * 1e-3 / busy:.2%} of the busy time; mha_tc_kernel {len(k2['tc'])}")
        if (len(k2["tc_bias"]), len(k2["tc"])) != (launches["mha"], 0):
            raise AssertionError(f"{label}: {len(k2['tc_bias'])} mha_tc_bias_kernel and "
                                 f"{len(k2['tc'])} mha_tc_kernel launches in the trace, "
                                 f"{launches['mha']} biased in a timed run")


def check_main_path(clip, n: int, launches: dict[str, int], cfg: PipelineConfig, cnn_calls: int,
                    crops_asked: int) -> None:
    """Shapes and values of one run's outputs, and each kernel's launches in
    that run, as the pipeline's configuration says: per detect batch one NMS
    call and, with the detector's fused switches, 3 fused_ssh_heads calls
    (with the mobilenet detector each with leaky 0.1, else with 0) and, in the
    r50 body, 5 fused_chain calls (layer1, layer2, three chunks of layer3); per
    emotion-CNN forward, fused, 7 fused_chain calls (1 + 2 + 2 + 2 over the
    four layers); one attention call per encoder layer per audio batch (12
    for wav2vec2, 24 for WavLM-Large), each in the tensor-core kernel. With
    the quantised
    profiles' shared extractor the full 4 s windows and the tail windows are
    batched apart, so the audio batches are counted for each group. The CNN is
    asked for every frame's crop, or with ``cnn_stride`` 0 for the step
    frames' only, and runs in batches of exactly its batch size. On the I420
    wire each detect batch is rebuilt once (``i420_to_bgr``), on ``bgr``
    never."""
    det, fused_cnn = cfg.detector, cfg.visual.fused
    detect_batches = -(-n // det.batch_size)
    windows = len(clip.audio_window_logits)
    if cfg.audio.shared_extractor:
        samples = CLIP_SECONDS * 16000
        full = sum(start + 64000 <= samples for start in range(0, samples + 1, 8000))
        audio_batches = -(-full // AUDIO_BATCH) + -(-(windows - full) // AUDIO_BATCH)
    else:
        audio_batches = -(-windows // AUDIO_BATCH)
    want_i420 = detect_batches if det.transfer_format == "i420" else 0
    layers = ENCODERS[cfg.audio.encoder]().num_layers
    body_chains = 5 * detect_batches if det.fused_layer1 and det.backbone == "resnet50" else 0
    want_chain = body_chains + (7 * cnn_calls if fused_cnn else 0)
    want_ssh = 3 * detect_batches if det.fused_ssh else 0
    leaky = 0.1 if det.backbone == MNET else 0.0
    # the target face's frames, and of those the ones cnn_stride serving computes
    present = np.flatnonzero(clip.face_boxes[:, 0] >= 0)
    cs = cfg.visual.cnn_stride or registry.dynamic_step(FPS)
    want_crops = int(cnn_compute_sel(present, registry.dynamic_step(FPS), cs)[0].sum())
    checks = {
        "stat_probs is [T, 7]": clip.stat_probs.shape == (n, 7),
        "stat_probs rows sum to 1": bool(np.allclose(clip.stat_probs.sum(1), 1.0, atol=1e-3)),
        "dyn_logits finite": bool(np.isfinite(clip.dyn_logits).all()),
        "audio logits finite": bool(np.isfinite(clip.audio_window_logits).all()),
        "audio logits are [17, 8]": clip.audio_window_logits.shape == (17, 8),
        "compound.av in 0..6": bool(clip.compound is not None
                                    and set(np.unique(clip.compound.av)) <= set(range(7))),
        f"the target face is on all {n} frames": len(present) == n,
        f"the CNN was asked for {want_crops} crops (cnn_stride {cfg.visual.cnn_stride})":
            crops_asked == want_crops,
        f"the emotion CNN ran {-(-want_crops // CNN_BATCH)} batches of {CNN_BATCH}":
            cnn_calls == -(-want_crops // CNN_BATCH),
        f"nms launches == {detect_batches} detect batches of {det.batch_size}":
            launches["nms_mask"] == detect_batches,
        f"i420_to_bgr launches == {want_i420} (the {det.transfer_format} wire)":
            launches["i420_to_bgr"] == want_i420,
        f"attention launches == {layers} x {audio_batches} audio batches":
            launches["mha"] == layers * audio_batches,
        "every attention launch went to the tensor-core kernel":
            (launches["mha_tc"], launches["mha_exact"]) == (launches["mha"], 0),
        f"fused_chain launches == {want_chain} ({body_chains} in the detector's body + "
        f"7 x {cnn_calls} CNN calls, fused only)": launches["fused_chain"] == want_chain,
        f"fused_ssh_heads launches == {want_ssh}": launches["fused_ssh_heads"] == want_ssh,
        f"every fused_ssh_heads launch had leaky {leaky}":
            fused_ssh_kernel.fused_ssh_heads.launches_by_leaky
            == ({leaky: want_ssh} if want_ssh else {}),
        "fused_chain_flat launches == 0 (no model calls it)": launches["fused_chain_flat"] == 0,
    }
    for name, ok in checks.items():
        log(f"  check {name}: {'ok' if ok else 'FAILED'}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}; launches {launches}")


def agreement(a, b, what: str, need: float) -> None:
    agree = float((a.compound.av == b.compound.av).mean())
    n = len(a.compound.av)
    log(f"{what} compound decisions: {int(round(agree * n))} of {n} frames agree (random weights "
        f"give near-ties; {need:.0%} required)")
    if agree < need:
        raise AssertionError(f"{what}: decisions agree on only {agree:.1%} of frames")


def same_results(got, want, what: str) -> None:
    """Two runs' outputs, which must be equal, not close."""
    diffs = {key: float(np.abs(getattr(got, key).astype(np.float64)
                               - getattr(want, key).astype(np.float64)).max())
             for key in ("stat_probs", "dyn_logits", "audio_window_logits", "face_boxes")}
    diffs["compound.av"] = float((got.compound.av != want.compound.av).sum())
    log(f"{what}: largest differences {diffs}")
    if any(diffs.values()):
        raise AssertionError(f"{what}: results differ: {diffs}")


def phase_run_many(card: str, pipe, frames: np.ndarray, wav: np.ndarray) -> None:
    """``Pipeline.run_many`` over two clips (the smoke clip and its reverse,
    audio from wav sidecars), two in flight, against the same two clips run
    one after the other: every output equal."""
    clip_dir = os.path.join(ROOT, "build", "smoke_clips")
    os.makedirs(clip_dir, exist_ok=True)
    clips = [("forward", frames, wav), ("reverse", frames[::-1].copy(), wav[::-1].copy())]
    for name, _, w in clips:
        write_wav(os.path.join(clip_dir, name + ".wav"), w, 16000)

    def readers():
        return [ArrayReader(f, FPS, os.path.join(clip_dir, name + ".avi")) for name, f, _ in clips]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [pipe.run(r, "") for r in readers()]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    many = pipe.run_many(readers(), "", overlap=2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for got, want in zip(many, serial):
        same_results(got, want, f"run_many vs serial, clip {got.name_video}")
    log(f"run_many: two clips of {CLIP_SECONDS} s, two in flight {t2 - t1:.3f} s "
        f"({2 * CLIP_SECONDS / (t2 - t1):.3f} video-sec/sec), one after the other "
        f"{t1 - t0:.3f} s ({2 * CLIP_SECONDS / (t1 - t0):.3f} video-sec/sec) on {card}")


def phase_presets(card: str, frames: np.ndarray, wav: np.ndarray, int8_clip) -> dict[str, int]:
    """The serving presets at full width, each pipeline built from what
    ``cli.run`` maps its profile to, one at a time (a pipeline is dropped
    before the next is built): ``max --fused`` with three timed runs, the
    others with one. Returns the ``fused_ssh_heads`` launches of the
    two paths that drive the kernel's int8 mode at C = 64 with leaky 0.1:
    ``fast --fused`` (the 640 bucket) and ``max --fused`` (the 448 bucket,
    every second frame)."""
    def preset(profile: str, fused: bool = False, timed_runs: int = 1, traced: bool = False):
        label = f"--serving_profile {profile}" + (" --fused" if fused else "")
        cfg = preset_config(profile, fused)
        pipe = build(card, fused, cfg=cfg, label=label)
        clip, launches = phase_main(card, pipe, fused, frames, wav, label=label,
                                    int8=cfg.visual.quant == "int8", timed_runs=timed_runs,
                                    profile=traced)
        return pipe, clip, launches

    # one timed run: the smoke's budget went to the I420, --calibrate and
    # build-cache phases (max --fused keeps three)
    turbo, turbo_clip, _ = preset("turbo")
    phase_reference_mobilenet(turbo.detect.inner.model, frames)
    phase_run_many(card, turbo, frames, wav)
    del turbo
    _, max_clip, max_launches = preset("max", fused=True, timed_runs=TIMED_RUNS, traced=True)
    _, turbo_fused_clip, _ = preset("turbo", fused=True)
    torch.cuda.empty_cache()
    # max is turbo with the static CNN on the step cadence only: the step
    # frames' features, and so the whole dynamic stream, must not move
    for key in ("dyn_logits", "face_boxes", "audio_window_logits"):
        equal = np.array_equal(getattr(max_clip, key), getattr(turbo_fused_clip, key))
        log(f"max --fused vs turbo --fused, {key} equal bit for bit: {equal}")
        if not equal:
            raise AssertionError(f"max --fused: {key} differs from turbo --fused's")
    held = float((max_clip.stat_probs != turbo_fused_clip.stat_probs).any(axis=1).mean())
    log(f"max --fused holds another static row than turbo --fused computes on {held:.1%} of frames")
    agreement(max_clip, turbo_fused_clip, "max --fused vs turbo --fused", 0.80)
    agreement(turbo_fused_clip, turbo_clip, "turbo --fused vs turbo", 0.80)
    # another detector (mobilenet0.25 at 448, every second frame) under the
    # forced top candidate crops another region than the r50 one: reported
    agreement(max_clip, int8_clip, "max --fused vs int8 (r50 detector)", 0.0)
    agreement(turbo_clip, int8_clip, "turbo vs int8 (r50 detector)", 0.0)

    # the other presets; with --fused the r50 kernels run at the 448 bucket's
    # shapes and the mobilenet detector's at the 640 bucket's
    for profile, fused in (("balanced", False), ("balanced", True), ("int8_s2", False),
                           ("int8_448", False), ("int8_448_s2", False), ("int8_448_s2", True),
                           ("fast", False), ("fast", True)):
        launches = preset(profile, fused)[2]
        if (profile, fused) == ("fast", True):
            fast_launches = launches
        torch.cuda.empty_cache()
    return {"fast --fused": fast_launches["fused_ssh_heads"],
            "max --fused": max_launches["fused_ssh_heads"]}


POS_CONV = "wav2vec2.encoder.pos_conv_embed.conv"


def write_release(ref, directory: str) -> torch.Tensor:
    """The seeded f32 models of ``ref`` as the reference's release files in
    ``directory``: the detector with the ``module.`` prefix, the audio model
    inside the trainer's ``model_state_dict`` wrapper with its positional
    conv as weight-norm factors (g = the norm of w over dims 0 and 1, v = w).
    Returns the weight those factors stand for, fused in f64 as the loader
    fuses them."""
    if os.path.isdir(directory):
        shutil.rmtree(directory)
    files = checkpoint.TORCH_FILES
    os.makedirs(os.path.join(directory, os.path.dirname(files["expr_model_8cl"])))
    torch.save({f"module.{k}": v for k, v in ref.detect.model.state_dict().items()},
               os.path.join(directory, files["retinaface"]))
    torch.save(ref.visual.static_model.state_dict(),
               os.path.join(directory, files["emotion_resnet50"]))
    torch.save(ref.visual.lstm_model.state_dict(), os.path.join(directory, files["temporal_lstm"]))
    sd = dict(ref.audio.model.state_dict())
    v = sd.pop(f"{POS_CONV}.weight")
    norm = np.sqrt((v.numpy().astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    g = torch.from_numpy(norm.astype(np.float32))
    sd[f"{POS_CONV}.parametrizations.weight.original0"] = g
    sd[f"{POS_CONV}.parametrizations.weight.original1"] = v
    torch.save({"model_state_dict": sd, "epoch": 0},
               os.path.join(directory, files["expr_model_8cl"]))
    return torch.from_numpy((g.numpy() * v.numpy() / norm).astype(np.float32))


def phase_release(card: str, ref, fused_pipe, frames: np.ndarray, wav: np.ndarray) -> float:
    """``parity --fused`` built from release files of the seeded weights
    against the same weights handed in directly (the seeded fused pipeline,
    its positional conv set to the weight the factors stand for): every
    output equal. Returns the build's wall."""
    directory = os.path.join(ROOT, "build", "smoke_release")
    t0 = time.perf_counter()
    pos_w = write_release(ref, directory)
    log(f"release files of the seeded weights written in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(preset_config("parity", fused=True), weights_dir=directory)
    released = build(card, True, cfg=cfg, label="parity --fused from release files")
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        fused_pipe.audio.model.wav2vec2.encoder.pos_conv_embed.conv.weight.copy_(pos_w)
    got = released.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    want = fused_pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    same_results(got, want, "parity --fused from release files vs the same weights handed in")
    return build_s


def count_files(root: str, pattern: str) -> int:
    return len(glob.glob(os.path.join(root, pattern)))


def heatmap_costs(card: str, title: str, pipe, frames: np.ndarray) -> None:
    """Where a run's host-side heatmap and crop time goes, each median of 3:
    Grad-CAM of one batch of 32 crops (the forward to layer4 and the masks),
    rendering the 32 overlays (also with cv2 on one thread), encoding them as
    jpgs; and for 200 face crops of the forced face's size the host crop's
    PIL-nearest resize and its jpg encoding."""
    import cv2

    from avcer_tpu_torch.pipeline.media import resize_nearest_np
    from avcer_tpu_torch.utils.gradcam import render_heatmap

    crops = np.random.default_rng(0).integers(0, 255, (32, 224, 224, 3), np.uint8)
    classes = np.zeros(32, np.int64)
    faces = [frames[i, 90:270, 160:480] for i in range(200)]

    def ms(fn) -> float:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    masks = pipe.visual.gradcam(crops, classes)
    overlays = [render_heatmap(m, c, image_weight=0.8) for m, c in zip(masks, crops)]
    costs = {
        "Grad-CAM of 32 crops": ms(lambda: pipe.visual.gradcam(crops, classes)),
        "32 overlays rendered": ms(lambda: [render_heatmap(m, c, image_weight=0.8)
                                            for m, c in zip(masks, crops)]),
        "32 overlays jpg-encoded": ms(lambda: [cv2.imencode(".jpg", o) for o in overlays]),
        "200 host crops [180, 320] resized to 224": ms(
            lambda: [resize_nearest_np(f, (224, 224)) for f in faces]),
        "200 host crops jpg-encoded": ms(lambda: [cv2.imencode(".jpg", f) for f in faces]),
    }
    # the same rendering with cv2 on one thread (the pipeline keeps cv2's
    # default), to see whether its thread pool is what costs
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        costs["32 overlays rendered, cv2 on 1 thread"] = ms(
            lambda: [render_heatmap(m, c, image_weight=0.8) for m, c in zip(masks, crops)])
    finally:
        cv2.setNumThreads(threads)
    log(f"{title}, host costs (ms, median of 3; cv2 threads {threads}, torch threads "
        f"{torch.get_num_threads()}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()) + f" on {card}")


def phase_surface(card: str, frames: np.ndarray, wav: np.ndarray) -> dict[str, dict[str, int]]:
    """The rest of ``cli.run``'s surface at full width, seeded weights:
    ``--fused --save_face_crops --heatmaps static --audio_classes 7`` (the
    host-crop path, ExprModel V2 with 7 classes), then ``--fused --heatmaps
    dynamic --audio_head v1`` (the device path, V1's GRU). Each: one warm-up
    run in which every distinct kernel call is held against its plain version
    (K1's and K3's included, though earlier paths showed their shapes), then
    one run with the counts set to 0 just before: every detect batch one K1
    and five K3 launches, every emotion-CNN forward (the static batches and
    the Grad-CAM forwards) seven K3 launches; the jpgs and heatmaps one a
    present frame and one a step frame; the audio CSV where the JAX package
    writes it. V1's audio stage, the GRU in f32 (cuDNN) and, for the record,
    in bf16, are timed against V3's. Returns each path's launch counts."""
    step = registry.dynamic_step(FPS)
    walls, path_launches = {}, {}
    for label, argv in (("host crops", ["--save_face_crops", "--heatmaps", "static",
                                        "--audio_classes", "7"]),
                        ("device path", ["--heatmaps", "dynamic", "--audio_head", "v1"])):
        cfg = dataclasses.replace(cli.config_from_args(cli.parse_args(["--fused"] + argv)),
                                  weights_dir=os.path.join(ROOT, "build", "smoke_no_weights"),
                                  save_plot=False)
        title = "--fused " + " ".join(argv)
        pipe = build(card, True, cfg=cfg, label=title)
        out = os.path.join(ROOT, "build", "smoke_surface", label.replace(" ", "_"))
        held: dict = {}
        cnn_calls = [0]
        hook = pipe.visual.static_model.register_forward_hook(
            lambda *_: cnn_calls.__setitem__(0, cnn_calls[0] + 1))
        for timed in (False, True):
            if os.path.isdir(out):
                shutil.rmtree(out)
            reset_counts()
            cnn_calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with holding_new_calls(held) if not timed else contextlib.nullcontext():
                clip = pipe.run(ArrayReader(frames, FPS, "smoke.avi"), out, wav=wav)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
        hook.remove()
        HELD.update(held)
        n = frames.shape[0]
        detect_batches = -(-n // DETECT_BATCH)
        steps = len(range(0, n, step))
        classes = cfg.audio.num_classes
        audio_csv = (f"audio_{cfg.audio.padding}_{cfg.audio.step_sec}/audio__smoke.csv"
                     if classes == 7 else "audio__smoke.csv")
        csv_cols = open(os.path.join(out, audio_csv)).readline().strip().split(",")
        checks = {
            "stat_probs is [T, 7], rows sum to 1": clip.stat_probs.shape == (n, 7) and bool(
                np.allclose(clip.stat_probs.sum(1), 1.0, atol=1e-3)),
            f"audio logits finite, [17, {classes}]": clip.audio_window_logits.shape == (17, classes)
            and bool(np.isfinite(clip.audio_window_logits).all()),
            f"audio CSV at {audio_csv} with {classes} emotions and frames":
                csv_cols == list(registry.AUDIO_EMOTIONS_8[:classes]) + ["frames"],
            f"{steps} heatmaps, one a step frame": count_files(
                out, f"smoke/heatmaps_{cfg.heatmaps}/*.jpg") == steps,
            f"{n if cfg.save_face_crops else 0} face crops, one a frame": count_files(
                out, "smoke/[0-9][0-9]/*.jpg") == (n if cfg.save_face_crops else 0),
            f"nms launches == {detect_batches} detect batches": launches["nms_mask"]
            == detect_batches,
            f"fused_chain launches == 5 x {detect_batches} + 7 x {cnn_calls[0]} CNN forwards":
                launches["fused_chain"] == 5 * detect_batches + 7 * cnn_calls[0],
            f"the CNN ran one static batch and {-(-steps // 32)} Grad-CAM forwards":
                cnn_calls[0] == 1 + -(-steps // 32),
            "every attention launch in the tensor-core kernel":
                launches["mha"] > 0 and launches["mha_tc"] == launches["mha"],
        }
        for name, ok in checks.items():
            log(f"  check {title}: {name}: {'ok' if ok else 'FAILED'}")
        if not all(checks.values()):
            raise AssertionError(f"{title}: checks failed; launches {launches}")
        held_k = sorted({name for name, _ in held.values()})
        if not {"nms_mask", "fused_chain"} <= set(held_k):
            raise AssertionError(f"{title}: K1 and K3 not held on the path: {held_k}")
        walls[title] = (wall, clip.timings)
        path_launches[title] = launches
        heatmap_costs(card, title, pipe, frames)
        log(f"{title}: held on this path {len(held)} distinct kernel calls ({', '.join(held_k)}); "
            f"launches {launches}")
        if label == "device path":
            v1 = pipe
        else:
            del pipe
    for title, (wall, timings) in walls.items():
        log(f"surface wall {title}: {wall:.3f} s ("
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()) + f") on {card}")

    # V1's audio stage against V3's (the parity --fused pipeline's), and the
    # GRU alone at a window batch in f32 (served) and in bf16
    v3 = build(card, True, cfg=preset_config("parity", fused=True), label="parity --fused")
    audio_ms = {}
    for head, pipe in (("v1", v1), ("v3", v3)):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.audio.run_from_wav(wav, FPS)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        audio_ms[head] = float(np.median(times[1:])) * 1e3
    gru = v1.audio.model.gru
    x = randn((AUDIO_BATCH, 199, gru.input_size), 0, torch.float32, relu=False)
    gru_bf16 = copy.deepcopy(gru).to(torch.bfloat16)
    with torch.inference_mode():
        f32_ms = median_ms(lambda: gru(x), runs=10)
        bf16_ms = median_ms(lambda: gru_bf16(x.bfloat16()), runs=10)
    log(f"audio stage, {CLIP_SECONDS} s clip (17 windows), median of 3 after one: V1 "
        f"{audio_ms['v1']:.1f} ms, V3 {audio_ms['v3']:.1f} ms; V1's GRU alone at "
        f"[{AUDIO_BATCH}, 199, {gru.input_size}]: f32 (served) {f32_ms:.3f} ms, bf16 "
        f"{bf16_ms:.3f} ms (median of 10) on {card}")
    return path_launches


#: the offline weight search at full size: aligned frames, streams, classes
EVAL_N, EVAL_M, EVAL_C = 1 << 18, 3, 7
EVAL_DIRICHLET, EVAL_HELD, EVAL_CPU_CHUNK = 10_000, 1024, 128
#: seeded S3FD weights score no anchor of the smoke clip above the served 0.8
#: (the largest score is about 0.66): at 0.5 the NMS has candidates to suppress
S3FD_THRESHOLD = 0.5


def events_ms(fn):
    """(ms, result) of one call between two CUDA events: the card's clock
    over the call, host work inside it included."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def run_cli(main, argv) -> tuple[int, str, float]:
    """(exit code, standard output, wall s) of an entry point's ``main``."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def seeded_corpus(n: int, seed: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """Labels and three probability streams of ``n`` aligned frames, each
    stream the softmax of noise plus a label signal of its own strength."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, EVAL_C, n)
    onehot = np.eye(EVAL_C)[labels]
    streams = []
    for strength in (1.5, 1.0, 0.5):
        logits = rng.normal(size=(n, EVAL_C)) + strength * onehot
        e = np.exp(logits - logits.max(1, keepdims=True))
        streams.append(e / e.sum(1, keepdims=True))
    return labels, streams


def phase_offline_eval(card: str, frames: np.ndarray, wav: np.ndarray) -> None:
    """The offline fusion evaluation: (a) ``cli.run --fused`` (seeded weights,
    the forced face) writes the output trees of the smoke clip and its
    reverse, seeded per-frame annotations (with -1 and 7 rows) go beside them,
    and ``cli.eval_offline --optimize_weights --num_dirichlet 10000 --device
    cuda`` runs over that tree; (b) the Dirichlet search of 10,000
    candidates and the 3-way grid of 1,000 at N = 2^18 aligned frames on the
    card, each call timed by CUDA events, and the device part alone (the
    10,000 candidates' metrics, a chunk of 1024 at a time); (c) the first
    1,024 candidates' UARs on the card equal, bit for bit, those of the
    port's own search on the CPU, and so does the chosen index."""
    import pandas as pd

    from avcer_tpu_torch.cli import eval_offline
    from avcer_tpu_torch.fusion import weight_search

    root = os.path.join(ROOT, "build", "smoke_eval")
    if os.path.isdir(root):
        shutil.rmtree(root)
    tree, ann, report = (os.path.join(root, d) for d in ("preds", "ann", "report"))
    clip_dir = os.path.join(ROOT, "build", "smoke_clips")
    os.makedirs(clip_dir, exist_ok=True)
    clips = [("forward", frames, wav), ("reverse", frames[::-1].copy(), wav[::-1].copy())]
    for name, _, w in clips:
        write_wav(os.path.join(clip_dir, name + ".wav"), w, 16000)
    cfg = dataclasses.replace(cli.config_from_args(cli.parse_args(["--fused"])),
                              weights_dir=os.path.join(ROOT, "build", "smoke_no_weights"))
    pipe = build(card, True, cfg=cfg, label="cli.run --fused, the trees for eval_offline")
    t0 = time.perf_counter()
    pipe.run_many([ArrayReader(f, FPS, os.path.join(clip_dir, name + ".avi"))
                   for name, f, _ in clips], tree, overlap=2)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    del pipe
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    os.makedirs(ann)
    for name, f, _ in clips:
        labels = rng.integers(0, 7, len(f))
        labels[rng.random(len(f)) < 0.05] = -1
        labels[rng.random(len(f)) < 0.05] = 7
        pd.DataFrame({"Neutral": labels}).to_csv(os.path.join(ann, name + ".csv"), index=False)
    rc, out, wall = run_cli(eval_offline.main, [
        "--ann_root", ann, "--preds_root", tree, "--save_root", report, "--optimize_weights",
        "--num_dirichlet", str(EVAL_DIRICHLET), "--device", DEVICE])
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    for ln in lines:
        log(f"eval_offline JSON: {json.dumps(ln)}")
    pickled = os.path.join(report, "metrics_dicts", "ABAW_metrics_dict_av_sd.pickle")
    checks = {
        "the run wrote both clips' static, dynamic and audio CSVs": all(
            os.path.exists(os.path.join(tree, f"{kind}__{name}.csv"))
            for name, _, _ in clips for kind in ("static", "dynamic", "audio")),
        "eval_offline exited 0 with two JSON lines": rc == 0 and len(lines) == 2,
        "the search's UARs and the fused metrics in [0, 1]": len(lines) == 2 and all(
            0 <= lines[i][k] <= 1 for i, k in ((0, "dirichlet_uar"), (0, "grid_uar"),
                                               (1, "uar_av"), (1, "f1_av"))),
        "the metrics pickle written": os.path.exists(pickled),
    }
    for name, ok in checks.items():
        log(f"  check eval_offline: {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"eval_offline over the port's trees: checks failed; output {out}")
    log(f"eval_offline over the port's output trees of two {CLIP_SECONDS} s clips: cli.run "
        f"(run_many) {run_s:.3f} s, eval_offline --optimize_weights --num_dirichlet "
        f"{EVAL_DIRICHLET} {wall:.3f} s wall on {card}")

    # (b) the search at full size
    labels, streams = seeded_corpus(EVAL_N, 1)
    torch.cuda.reset_peak_memory_stats()
    weight_search.search_grid(labels, streams, device=DEVICE)  # warm-up
    t0 = time.perf_counter()
    cands = weight_search.dirichlet_weights(EVAL_DIRICHLET, EVAL_M, EVAL_C, 42)
    draw_ms = (time.perf_counter() - t0) * 1e3
    dir_ms, (best_w, best_u) = events_ms(lambda: weight_search.search_dirichlet(
        labels, streams, num_weights=EVAL_DIRICHLET, seed=42, device=DEVICE))
    grid_ms, (combo, grid_u) = events_ms(lambda: weight_search.search_grid(
        labels, streams, device=DEVICE))
    preds = torch.from_numpy(np.stack(streams).astype(np.float32))
    labels_t = torch.from_numpy(labels)
    preds_d, labels_d = preds.to(DEVICE), labels_t.to(DEVICE)
    w_all = torch.from_numpy(cands.astype(np.float32))
    device_ms_sum, uars = 0.0, []
    for s in range(0, EVAL_DIRICHLET, 1024):
        ms, res = events_ms(lambda: weight_search.evaluate_candidates(
            preds_d, labels_d, w_all[s:s + 1024].to(DEVICE)))
        device_ms_sum += ms
        uars.append(res[0])
    best_i = int(torch.cat(uars).argmax())
    if not (np.array_equal(best_w, cands[best_i]) and best_u == float(torch.cat(uars)[best_i])):
        raise AssertionError("search_dirichlet chose another candidate than its own metrics say")
    # where a chunk's device time goes, by kernel (one call, profiler trace)
    by_kernel: dict[str, float] = {}
    for e in device_kernels(lambda: weight_search.evaluate_candidates(
            preds_d, labels_d, w_all[:1024].to(DEVICE)), runs=1, warmup=0) or ():
        name = e["name"][:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + float(e["dur"]) * 1e-3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    log(f"evaluate_candidates, one chunk of 1024 at N = {EVAL_N}: device "
        f"{sum(by_kernel.values()):.1f} ms, by kernel: "
        + "; ".join(f"{name} {ms:.1f} ms" for name, ms in top) + f" on {card}")
    bytes_in = tensor_bytes(preds_d, labels_d, w_all)
    ops = 5.0 * EVAL_DIRICHLET * EVAL_N * EVAL_C  # three products and two sums an element
    bound, by = bound_ms(bytes_in, ops, "f32")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"weight search at N = {EVAL_N} aligned frames, M = {EVAL_M}, C = {EVAL_C}: "
        f"search_dirichlet {EVAL_DIRICHLET} candidates {dir_ms:.1f} ms (CUDA events over the "
        f"call; the host's draw of the candidates alone {draw_ms:.1f} ms), best UAR "
        f"{best_u:.6f} at candidate {best_i}; evaluate_candidates alone {device_ms_sum:.1f} ms "
        f"in chunks of 1024 (bound {bound:.3f} ms, {by}); search_grid {len(combo)}-way "
        f"{10 ** len(combo)} combinations {grid_ms:.1f} ms, best UAR {grid_u:.6f} at "
        f"{[round(c, 2) for c in combo]}; peak device memory of the searches "
        f"{peak_gb:.1f} GiB, on {card}")

    # (c) the first 1,024 candidates against the port's own search on the CPU
    t0 = time.perf_counter()
    cpu_uar = torch.cat([weight_search.evaluate_candidates(
        preds, labels_t, w_all[s:s + EVAL_CPU_CHUNK])[0]
        for s in range(0, EVAL_HELD, EVAL_CPU_CHUNK)])
    cpu_s = time.perf_counter() - t0
    card_uar = torch.cat(uars)[:EVAL_HELD].cpu()
    differ = int((card_uar != cpu_uar).sum())
    same_pick = int(card_uar.argmax()) == int(cpu_uar.argmax())
    log(f"weight search, the first {EVAL_HELD} candidates at N = {EVAL_N}: card against the "
        f"CPU ({cpu_s:.1f} s, {torch.get_num_threads()} threads): {differ} UARs differ, "
        f"chosen index {int(card_uar.argmax())} on the card, {int(cpu_uar.argmax())} on the "
        "CPU")
    if differ or not same_pick:
        raise AssertionError(f"weight search: the card's UARs differ from the CPU's at {differ} "
                             f"candidates, same pick {same_pick}")


def phase_preprocess(card: str, wav: np.ndarray) -> None:
    """The preprocessing copies, host work: ``spectral_vad`` with and without
    ``separate_fusion`` on the smoke wav, ``build_vad_pickle(separate_fusion=
    True)`` over a directory holding it, and ``extract_surface_area`` over the
    face crops the host-crop path wrote; counts checked, host times printed."""
    from avcer_tpu_torch.pipeline import preprocess
    from avcer_tpu_torch.pipeline.media import read_wav

    root = os.path.join(ROOT, "build", "smoke_preprocess")
    if os.path.isdir(root):
        shutil.rmtree(root)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir)
    times, found = {}, {}
    for fusion in (False, True):
        t0 = time.perf_counter()
        found[fusion] = preprocess.spectral_vad(wav, 16000, separate_fusion=fusion)
        times[f"spectral_vad separate_fusion={fusion}"] = time.perf_counter() - t0
    write_wav(os.path.join(wav_dir, "smoke.wav"), wav, 16000)
    t0 = time.perf_counter()
    pkl = preprocess.build_vad_pickle(wav_dir, os.path.join(root, "vad.pickle"),
                                      separate_fusion=True)
    times["build_vad_pickle"] = time.perf_counter() - t0
    with open(pkl, "rb") as fh:
        info = pickle.load(fh)
    back, _ = read_wav(os.path.join(wav_dir, "smoke.wav"))
    crops = os.path.join(ROOT, "build", "smoke_surface", "host_crops")
    jpgs = count_files(crops, "smoke/00/*.jpg")
    t0 = time.perf_counter()
    written = preprocess.extract_surface_area(crops, os.path.join(root, "mouth"))
    times["extract_surface_area"] = time.perf_counter() - t0
    import pandas as pd

    df = pd.read_csv(written[0], index_col=0) if written else None

    def well_formed(segs) -> bool:
        return all(0 <= a["start"] < a["end"] <= len(wav) for a in segs) and all(
            a["end"] <= b["start"] for a, b in zip(segs, segs[1:]))

    checks = {
        "the VAD segments lie in the wav, in order": well_formed(found[False])
        and well_formed(found[True]),
        "the pickle holds smoke.wav, its segments those of spectral_vad on the file":
            list(info) == ["smoke.wav"]
            and info["smoke.wav"] == preprocess.spectral_vad(back[0], 16000,
                                                             separate_fusion=True),
        f"one mouth-open CSV of {jpgs} rows, one a crop": jpgs > 0 and df is not None
        and len(written) == 1 and len(df) == jpgs
        and list(df.columns) == ["frame", "surface_area_mouth", "mouth_open"],
        "mouth_open is 0 or 1, 0 on the first 29 rows": df is not None
        and set(df["mouth_open"]) <= {0, 1} and not df["mouth_open"][:29].any(),
    }
    for name, ok in checks.items():
        log(f"  check preprocess: {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("preprocess: checks failed")
    log(f"preprocess on the {CLIP_SECONDS} s smoke wav: segments {len(found[False])} raw, "
        f"{len(found[True])} with separate_fusion; pickle {len(info)} file; mouth-open CSV "
        f"{len(df)} rows from {jpgs} crops; host times "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items()) + f" (host of {card})")


def write_video(path: str, frames: np.ndarray) -> None:
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (WIDTH, HEIGHT))
    for f in frames:
        vw.write(f)
    vw.release()


def kept_boxes_agree(got: np.ndarray, want: np.ndarray, atol: float) -> bool:
    """Each frame's kept boxes, as sets, within ``atol`` px of each other."""
    for g, w in zip(got, want):
        kg, kw = g[g[:, 5] > 0.5, :4], w[w[:, 5] > 0.5, :4]
        if len(kg) != len(kw):
            return False
        used = np.zeros(len(kw), bool)
        for box in kg:
            hit = np.flatnonzero(~used & (np.abs(kw - box).max(1) <= atol))
            if not hit.size:
                return False
            used[hit[0]] = True
    return True


def phase_s3fd(card: str, frames: np.ndarray) -> dict:
    """``cli.detect_demo`` on the smoke clip written as a video: S3FD (seeded
    weights written as ``s3fd_weights.pth``, 640 long side, batches of 32,
    bf16, ``--threshold 0.5``), then RetinaFace r50. Each: one run in which
    every distinct kernel call is held against its plain version, then one
    with the counts set to 0 just before: K1 7 launches, all in the S3FD run
    in its ``plus_one=False`` mode, all in the RetinaFace run in its +1 mode;
    the annotated video written. Then the first batch through the S3FD stage
    on the card against the same weights in f32 on the CPU: the card in f32,
    its kept boxes as sets within 0.01 px (and row for row, keep masks equal,
    where the candidates come in the same order); the served bf16 forward's
    regressions and scores on the first 4 frames within 5 % relative L2. K1's numbers in its
    no-+1 mode at the S3FD path's first call. Returns K1's launches by path
    and those numbers."""
    from avcer_tpu_torch.cli import detect_demo
    from avcer_tpu_torch.core import convert
    from avcer_tpu_torch.models.s3fd import S3FDNet
    from avcer_tpu_torch.pipeline.detect_s3fd import S3FD_RGB_MEAN, S3FDStage
    from avcer_tpu_torch.pipeline.media import VideoReader

    root = os.path.join(ROOT, "build", "smoke_s3fd")
    if os.path.isdir(root):
        shutil.rmtree(root)
    wdir = os.path.join(root, "weights")
    os.makedirs(wdir)
    model = S3FDNet()
    layers.seeded_init_(model, torch.Generator().manual_seed(0))
    model.reset_l2norm_scales()
    wfile = os.path.join(wdir, checkpoint.TORCH_FILES["s3fd"])
    torch.save(model.state_dict(), wfile)
    clip = os.path.join(root, "smoke.avi")
    write_video(clip, frames)
    n = frames.shape[0]
    batches = -(-n // DETECT_BATCH)
    launches_by_path, fps = {}, {}
    for method, extra in (("s3fd", ["--threshold", str(S3FD_THRESHOLD)]), ("retinaface", [])):
        title = f"detect_demo --method {method}"
        out = os.path.join(root, f"annotated_{method}.avi")
        argv = ["--input", clip, "--method", method, "--weights_dir", wdir, "--output", out,
                "--device", DEVICE] + extra
        held: dict = {}
        with holding_new_calls(held):
            rc, _, _ = run_cli(detect_demo.main, argv)
        reset_counts()
        rc2, printed, wall = run_cli(detect_demo.main, argv)
        launches = counts()
        by_mode = dict(nms_kernel.nms_mask.launches_by_mode)
        HELD.update(held)
        line = printed.strip().splitlines()[0] if printed.strip() else ""
        m = re.fullmatch(r"(\d+) frames, faces on (\d+), ([\d.]+) fps", line)
        plus_one = method == "retinaface"
        checks = {
            "exit 0 twice": rc == rc2 == 0,
            f"'{n} frames, faces on F, X fps'": bool(m) and int(m.group(1)) == n,
            f"K1 launches == {batches} detect batches, all with plus_one={plus_one}":
                launches["nms_mask"] == batches and by_mode == {plus_one: batches,
                                                                not plus_one: 0},
            "K1 held on the path": any(name == "nms_mask" for name, _ in held.values()),
            "the annotated video written": os.path.exists(out) and os.path.getsize(out) > 0,
        }
        for name, ok in checks.items():
            log(f"  check {title}: {name}: {'ok' if ok else 'FAILED'}")
        if not all(checks.values()):
            raise AssertionError(f"{title}: checks failed; printed {printed!r}, launches "
                                 f"{launches}, by mode {by_mode}")
        launches_by_path[f"{title} (plus_one={plus_one})"] = launches["nms_mask"]
        fps[method] = float(m.group(3))
        log(f"{title}: {line} (demo wall {wall:.2f} s with the model's build and the "
            f"annotated video) on {card}")

    # the first batch, card against the CPU, and the detector alone
    stage = detect_demo.build_stage("s3fd", "resnet50", S3FD_THRESHOLD, 640, wdir,
                                    device=DEVICE)
    reader = VideoReader(clip)
    first, _ = next(reader.batches(DETECT_BATCH))
    reader.release()
    x_dev, _ = stage.prepare_batch(first)
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return nms_kernel.nms_mask(*args, **kw)

    detect_s3fd_module.nms_mask = capture
    try:
        packed16 = stage.forward(x_dev).cpu().numpy()
    finally:
        detect_s3fd_module.nms_mask = nms_kernel.nms_mask
    (boxes, valid, thresh), kw = calls[0]
    keep = nms_kernel.nms_mask(boxes, valid, thresh, **kw)
    numbers = nms_numbers(boxes, valid, keep, thresh, plus_one=False)
    numbers["valid_per_frame"] = float(valid.float().sum(1).mean())
    numbers["kept_per_frame"] = float(keep.float().sum(1).mean())
    model32 = S3FDNet()
    model32.load_state_dict(convert.release_state_dict(
        "s3fd", checkpoint.load_torch_state_dict(wfile)), strict=True)
    model32.eval().requires_grad_(False)
    cfg = stage.cfg
    t0 = time.perf_counter()
    cpu_stage = S3FDStage(cfg, model32, device="cpu")
    packed_cpu = cpu_stage.forward(cpu_stage.prepare_batch(first)[0]).numpy()
    cpu_s = time.perf_counter() - t0
    card32 = S3FDStage(cfg, copy.deepcopy(model32).to(DEVICE), device=DEVICE)
    packed32 = card32.forward(x_dev).cpu().numpy()
    mean = torch.tensor(S3FD_RGB_MEAN)
    x_cpu = torch.from_numpy(first[:4]).flip(-1).float() - mean
    with torch.inference_mode():
        want = model32(x_cpu)
        got16 = stage.model(x_cpu.to(DEVICE))
    errs = {name: rel_l2(g.float().cpu(), w) for name, g, w in zip(("loc", "conf"), got16, want)}
    same_order = np.abs(packed32[..., :4] - packed_cpu[..., :4]).max(axis=(1, 2)) <= 0.01
    rows_equal = bool((packed32[same_order, :, 5] == packed_cpu[same_order, :, 5]).all())
    checks = {
        "f32 card vs f32 CPU: kept boxes agree as sets within 0.01 px":
            kept_boxes_agree(packed32, packed_cpu, 0.01),
        f"f32 card vs f32 CPU: keep masks equal row for row on the {int(same_order.sum())} "
        f"of {len(first)} frames whose candidates come in the same order": rows_equal,
        "f32 card vs f32 CPU: scores within 1e-5": bool(
            np.abs(packed32[..., 4] - packed_cpu[..., 4]).max() <= 1e-5),
        "bf16 card vs f32 CPU, first 4 frames: loc and conf within 5 % relative L2":
            max(errs.values()) < 0.05,
        "landmark slots zero": bool((packed16[..., 6:] == 0).all()),
    }
    agree16 = np.mean([kept_boxes_agree(packed16[i:i + 1], packed_cpu[i:i + 1], 1.0)
                       for i in range(len(first))])
    for name, ok in checks.items():
        log(f"  check S3FD first batch: {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("S3FD card outputs disagree with the f32 CPU reference")
    # the detector alone, the clip's 7 batches, frames already decoded
    reader = VideoReader(clip)
    decoded = [b for b, _ in reader.batches(DETECT_BATCH)]
    reader.release()
    for b in decoded[:1]:
        stage.dispatch(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in decoded:
        packed, scale, _ = stage.dispatch(b)
        stage.unpack(packed.cpu().numpy(), scale)
    detect_s = time.perf_counter() - t0
    log(f"S3FD first batch: bf16 card vs f32 CPU relative L2 (first 4 frames) {errs}, kept "
        f"boxes within 1 px "
        f"on {agree16:.0%} of frames (reported); the f32 CPU stage {cpu_s:.1f} s; the stage "
        f"alone over {n} frames ({len(decoded)} batches, decoded): {detect_s * 1e3:.1f} ms = "
        f"{n / detect_s:.1f} fps; K1 no-+1 at {numbers['shape']}: {numbers['ms']:.4f} ms a "
        f"call, device {ms_text(numbers['device_ms'])}, plain {numbers['plain_ms']:.4f} ms, bound "
        f"{numbers['bound_ms']:.6f} ms ({numbers['bound_by']}); "
        f"{numbers['valid_per_frame']:.1f} valid and {numbers['kept_per_frame']:.1f} kept "
        f"candidates a frame, on {card}")
    numbers.update(demo_fps=fps, stage_fps=n / detect_s)
    return {"launches_by_path": launches_by_path, "s3fd_mode": numbers}


TRAIN_BATCH, TRAIN_STEPS = 24, 3  # cli.train_audio's batch; steps an epoch in the smoke corpus
TRAIN_SR, TRAIN_FPS = 16000, 25
TRAIN_LOG = "avcer_tpu_torch"


class Always(dict):
    """A ``holding_new_calls`` record that holds every call, not only the
    first of each signature; ``calls`` lists (entry, error) of each."""

    def __init__(self):
        super().__init__()
        self.calls: list = []

    def __contains__(self, key) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        self.calls.append(value)
        super().__setitem__(key, value)


def write_training_corpus(root: str, seed: int) -> dict:
    """A seeded ABAW-EXPR + MELD corpus in the layouts the loaders read: two
    48 s ABAW videos (labels 0-7 at 25 fps with a header line, every mouth
    open, a 16 kHz wav each, a 4-frame MJPG video for the frame rate) and
    five 10 s MELD utterances (labels csv, VAD pickle, wavs). 73 windows of
    4 s: three batches of 24. Returns cli.train_audio's config keys."""
    import cv2
    import pandas as pd

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("wav", "labels", "feats", "video", "meld")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for v in range(2):
        n = 1200
        with open(os.path.join(dirs["labels"], f"video{v}.txt"), "w") as f:
            f.write("Neutral,Anger,Disgust,Fear,Happiness,Sadness,Surprise,Other\n")
            f.write("\n".join(str(int(x)) for x in rng.integers(0, 8, n)) + "\n")
        pd.DataFrame({"feat_id": np.arange(n), "frame": np.arange(1, n + 1),
                      "surface_area_mouth": rng.random(n), "mouth_open": np.ones(n, int)}
                     ).to_csv(os.path.join(dirs["feats"], f"video{v}.csv"), index=False)
        write_wav(os.path.join(dirs["wav"], f"video{v}.wav"),
                  (rng.normal(size=(n // TRAIN_FPS + 1) * TRAIN_SR) * 0.1).astype(np.float32),
                  TRAIN_SR)
        vw = cv2.VideoWriter(os.path.join(dirs["video"], f"video{v}.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), TRAIN_FPS, (64, 64))
        for _ in range(4):
            vw.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
        vw.release()
    emotions = ["neutral", "anger", "disgust", "fear", "joy", "sadness", "surprise"]
    rows, vad = [], {}
    for u in range(5):
        fn = f"dia{u}_utt{u}.wav"
        rows.append({"Dialogue_ID": u, "Utterance_ID": u, "Emotion": emotions[u]})
        n = 10 * TRAIN_SR
        write_wav(os.path.join(dirs["meld"], fn), (rng.normal(size=n) * 0.1).astype(np.float32),
                  TRAIN_SR)
        vad[fn] = [{"start": TRAIN_SR // 5, "end": n - 3 * TRAIN_SR // 10}]
    pd.DataFrame(rows).to_csv(os.path.join(root, "meld.csv"), index=False)
    with open(os.path.join(root, "vad.pickle"), "wb") as f:
        pickle.dump(vad, f)
    return {"ABAW_WAV_ROOT": dirs["wav"], "ABAW_FILTERED_WAV_ROOT": dirs["wav"],
            "ABAW_VIDEO_ROOT": dirs["video"], "ABAW_LABELS_ROOT": dirs["labels"],
            "ABAW_FEATURES_ROOT": dirs["feats"], "MELD_WAV_ROOT": dirs["meld"],
            "MELD_LABELS_PATH": os.path.join(root, "meld.csv"),
            "MELD_VAD_PATH": os.path.join(root, "vad.pickle")}


@contextlib.contextmanager
def recording_steps(records: list):
    """Every ``Trainer.train_step`` of the body, timed by the host clock
    after a synchronise, with its loss, its K2 launches, the peak device
    memory so far and, for a model with wav2vec2, the gradient norms of the
    last encoder layer's q, k and v projections."""
    from avcer_tpu_torch.train.trainer import Trainer

    step = Trainer.train_step

    def recorded(self, state, x, y):
        torch.cuda.synchronize()
        before = attention_kernel.mha.launches
        t0 = time.perf_counter()
        out = step(self, state, x, y)
        torch.cuda.synchronize()
        rec = {"ms": (time.perf_counter() - t0) * 1e3, "loss": out[1],
               "mha": attention_kernel.mha.launches - before,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        w2v = getattr(state.model, "wav2vec2", None)
        if w2v is not None:
            attn = w2v.encoder.layers[-1].attention
            rec["grad_qkv"] = [float(getattr(attn, f"{p}_proj").weight.grad.norm())
                               for p in "qkv"]
        records.append(rec)
        return out

    Trainer.train_step = recorded
    try:
        yield
    finally:
        Trainer.train_step = step


@contextlib.contextmanager
def log_lines(lines: list):
    """The port's log records of the body, as text."""
    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep(level=logging.INFO)
    logger = logging.getLogger(TRAIN_LOG)
    old = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)


def train_run(card: str, title: str, main, argv, records: list, hold: bool) -> dict:
    """One training entry point run with the counts set to 0 just before;
    with ``hold`` every kernel call of the run held against its plain
    version. Returns the run's counts, its log lines and the held calls."""
    held, lines = Always(), []
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first = len(records)
    t0 = time.perf_counter()
    with log_lines(lines), recording_steps(records), \
            (holding_new_calls(held) if hold else contextlib.nullcontext()):
        rc, _, _ = run_cli(main, argv)
    wall = time.perf_counter() - t0
    launches = counts()
    steps = records[first:]
    if rc != 0:
        raise AssertionError(f"{title}: exit {rc}")
    per_step = (f"{len(steps)} steps, step ms {[round(s['ms'], 1) for s in steps]} (the first "
                f"with its warm-up), loss {[round(s['loss'], 4) for s in steps]}, K2 launches a "
                f"step {[s['mha'] for s in steps]}, peak device memory "
                f"{max(s['peak_gib'] for s in steps):.2f} GiB; " if steps else "")
    log(f"{title}: {wall:.1f} s wall; {per_step}launches {launches}"
        + (f"; {len(held.calls)} kernel calls held against the plain versions, largest error "
           f"{max((e for _, e in held.calls), default=0.0):.3g}" if hold else "")
        + f" on {card}")
    return {"launches": launches, "lines": lines, "held": held.calls, "steps": steps,
            "wall_s": wall}


def check(title: str, checks: dict) -> None:
    for name, ok in checks.items():
        log(f"  check {title}: {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"{title}: checks failed")


def train_audio_runs(card: str, root: str, corpus: dict) -> dict:
    """cli.train_audio at full width: V3 (12 layers, the last 4 trained),
    8 classes, batches of 24 4 s windows, REMAT and AUGMENTATION on, bf16;
    2 epochs, then ``--resume`` for a third; then V1 at 7 classes (soft
    focal) for one epoch. K2 launches every step, one a frozen layer."""
    import pandas as pd

    from avcer_tpu_torch.cli import train_audio

    records: list = []
    out = {}
    for variant, classes, frozen in (("v3", 8, 8), ("v1", 7, 10)):
        logs = os.path.join(root, f"logs_{variant}")
        cfg = dict(train_audio.example_config(), **corpus, LOGS_ROOT=logs,
                   MODEL_PARAMS={"model": variant, "num_classes": classes},
                   AUGMENTATION=True, FILTERED=True, NUM_EPOCHS=1 if variant == "v1" else 2,
                   BATCH_SIZE=TRAIN_BATCH, REMAT=True)
        path = os.path.join(root, f"train_{variant}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        argv = ["--config", path, "--device", DEVICE]
        runs = [train_run(card, f"cli.train_audio {variant} {classes} classes"
                          + (", epochs 0-1" if variant == "v3" else ", epoch 0"),
                          train_audio.main, argv, records, hold=variant == "v1")]
        if variant == "v3":
            runs.append(train_run(card, "cli.train_audio v3 8 classes --resume --epochs 3",
                                  train_audio.main, argv + ["--resume", "--epochs", "3"],
                                  records, hold=True))
        steps = [s for r in runs for s in r["steps"]]
        stats = pd.read_csv(os.path.join(logs, "run", "stats.csv"))
        checks = {
            "every loss finite": all(np.isfinite(s["loss"]) for s in steps),
            f"K2 launches {frozen} a step (one a frozen encoder layer)":
                all(s["mha"] == frozen for s in steps) and bool(steps),
            "every K2 launch in the tensor-core kernel":
                all(r["launches"]["mha_exact"] == 0 for r in runs),
            "the last encoder layer's q, k, v gradients non-zero every step":
                all(min(s["grad_qkv"]) > 0 for s in steps),
            "the best export written": os.path.exists(os.path.join(logs, f"best_{variant}.pth")),
        }
        if variant == "v3":
            checks.update({
                f"{TRAIN_STEPS} steps an epoch": [len(r["steps"]) for r in runs] ==
                                                 [2 * TRAIN_STEPS, TRAIN_STEPS],
                "--resume continues from epoch 1": any(
                    "resumed from epoch 1" in m for m in runs[1]["lines"]),
                "stats.csv holds epochs 0, 1, 2": stats["epoch"].tolist() == [0, 1, 2],
                "every K2 call of the resumed epoch held": len(runs[1]["held"]) ==
                                                           TRAIN_STEPS * frozen,
            })
        else:
            checks["every K2 call held"] = len(runs[0]["held"]) == len(steps) * frozen
        check(f"cli.train_audio {variant}", checks)
        out[variant] = {"runs": runs, "logs": logs, "config": path, "stats": stats}
    return out


def write_crops(root: str, seed: int, n: int) -> None:
    """``n`` seeded 224 x 224 jpg crops in ``root/<class>/`` over 7 classes."""
    import cv2

    rng = np.random.default_rng(seed)
    for i in range(n):
        d = os.path.join(root, str(i % 7))
        os.makedirs(d, exist_ok=True)
        cv2.imwrite(os.path.join(d, f"{i:04d}.jpg"), rng.integers(0, 255, (224, 224, 3), np.uint8))


def train_visual_runs(card: str, root: str) -> dict:
    """cli.train_visual: static (EmotionResNet50, batches of 64 224 x 224
    seeded jpg crops, bf16, 3 steps) and dynamic (TemporalLSTM, f32, seeded
    .npz features, 2 epochs)."""
    from avcer_tpu_torch.cli import train_visual

    crops, feats = os.path.join(root, "crops"), os.path.join(root, "features")
    write_crops(crops, 1, 3 * 64)
    os.makedirs(feats)
    rng = np.random.default_rng(2)
    for i in range(8):
        np.savez(os.path.join(feats, f"video{i}.npz"),
                 features=rng.normal(size=(200, 512)).astype(np.float32),
                 labels=rng.integers(0, 7, 200))
    records: list = []
    out = {}
    for model, data, extra in (("static", crops, ["--epochs", "1", "--batch_size", "64"]),
                               ("dynamic", feats, ["--epochs", "2", "--batch_size", "64"])):
        logs = os.path.join(root, f"logs_{model}")
        run = train_run(card, f"cli.train_visual --model {model}", train_visual.main,
                        ["--data_root", data, "--model", model, "--log_root", logs,
                         "--device", DEVICE] + extra, records, hold=False)
        best = checkpoint.load_torch_state_dict(os.path.join(logs, f"best_{model}.pth"))
        checks = {"every loss finite": all(np.isfinite(s["loss"]) for s in run["steps"]),
                  "steps": len(run["steps"]) == (3 if model == "static" else 2 * 4)}
        if model == "static":
            # every BatchNorm starts at mean 0 and variance 1 (seeded init)
            moved = max(max(float(best[k].abs().max()) for k in best if k.endswith("running_mean")),
                        max(float((best[k] - 1).abs().max()) for k in best
                            if k.endswith("running_var")))
            out["bn_running_change"] = moved
            checks["the BatchNorm running statistics moved"] = moved > 0
            log(f"cli.train_visual --model static: largest change of a BatchNorm running "
                f"statistic after 3 steps {moved:.4g} (momentum 0.01)")
        check(f"cli.train_visual --model {model}", checks)
        out[model] = run
    return out


def extract_features_run(card: str, root: str, audio: dict) -> dict:
    """cli.extract_features from the V3 run's best export over the ABAW
    windows, every K2 call held against its plain version."""
    from avcer_tpu_torch.cli import extract_features

    v3 = audio["v3"]
    out_path = os.path.join(root, "features.pkl")
    run = train_run(card, "cli.extract_features", extract_features.main,
                    ["--config", v3["config"], "--checkpoint",
                     os.path.join(v3["logs"], "best_v3.pth"), "--out", out_path,
                     "--device", DEVICE], [], hold=True)
    with open(out_path, "rb") as f:
        grouped = pickle.load(f)
    n = sum(len(g["targets"]) for g in grouped.values())
    batches = -(-n // 16)
    check("cli.extract_features", {
        "two files, logits [n, 8] and features [n, 1024], finite": len(grouped) == 2 and all(
            g["predicts"].shape[1:] == (8,) and g["features"].shape[1:] == (1024,)
            and np.isfinite(g["predicts"]).all() and np.isfinite(g["features"]).all()
            for g in grouped.values()),
        f"K2 launches 12 a batch of 16 ({batches} batches)":
            run["launches"]["mha_tc"] == 12 * batches,
        "every K2 call held": len(run["held"]) == 12 * batches,
    })
    return run


def detector_runs(card: str) -> dict:
    """train_synthetic_detector (mobilenet0.25, 256, batch 4, 20 steps) and
    evaluate_bucket_recall at native resolution and the 320 bucket (8
    scenes each, 640 x 360): once on the detect stage's eager route with
    every K1 call held (a replayed graph calls no wrapper), once as served
    (the piecewise graphs), with the same recall."""
    from avcer_tpu_torch.train import detection

    t0 = time.perf_counter()
    sd, losses = detection.train_synthetic_detector(steps=20, image_size=256, batch=4,
                                                    device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    def evaluate():
        return detection.evaluate_bucket_recall(sd, scene_hw=(HEIGHT, WIDTH), buckets=[0, 320],
                                                size_bins=[32, 64, 128], n_scenes=8,
                                                device=DEVICE)

    held = Always()
    reset_counts()
    t0 = time.perf_counter()
    eager_reason = detect_module.DetectStage.eager_reason
    detect_module.DetectStage.eager_reason = lambda self, model, device: "every K1 call held"
    try:
        with holding_new_calls(held):
            res = evaluate()
    finally:
        detect_module.DetectStage.eager_reason = eager_reason
    eval_s = time.perf_counter() - t0
    launches = counts()
    graphed = evaluate()
    log(f"train_synthetic_detector: 20 steps in {train_s:.2f} s, loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}; evaluate_bucket_recall {eval_s:.2f} s: {res}; launches {launches}, "
        f"{len(held.calls)} K1 calls held, on {card}")
    check("detector training", {
        "every loss finite": all(np.isfinite(losses)),
        "K1 launches 16 (2 buckets x 8 scenes, batches of one)": launches["nms_mask"] == 16,
        "every K1 call held": len(held.calls) == 16,
        "recall in [0, 1]": all(0 <= r["recall"] <= 1 for b in res.values() for r in b.values()),
        "the same recall and IoU served on the piecewise graphs": graphed == res,
    })
    return {"launches": launches["nms_mask"], "losses": losses, "recall": res,
            "train_s": train_s, "eval_s": eval_s}


def step_against_cpu(card: str) -> dict:
    """One train step of ExprModel V3 at full width (12 layers, 4 trained),
    batch 2 of 4 s, f32, dropout off, no mixup, on the card and on the CPU
    from the same seeded weights: the loss within rtol 1e-4, the trainable
    gradient within 1e-3 relative L2, and the updated parameters: Adam's
    first update is lr * g / (|g| + 1e-8), so where |g| is above 1e-4 of the
    largest gradient both sides move by lr to rounding (atol lr / 100), and
    everywhere within 2 lr."""
    from avcer_tpu_torch.core.config import TrainConfig
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 4 * TRAIN_SR)) * 0.5).astype(np.float32)
    y = rng.integers(0, 8, 2)
    cfg = TrainConfig()
    sides = {}
    for device in ("cpu", DEVICE):
        trainer = Trainer(ExprModel("v3", 8), cfg, iters_per_epoch=3, device=device)
        state = trainer.init_state(seed=0)
        layers.set_dropout(state.model, p=0.0)
        start = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()
                 if p.requires_grad}
        reset_counts()
        t0 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, x, y)
        if device != "cpu":
            torch.cuda.synchronize()
        sides[device] = {"loss": loss, "s": time.perf_counter() - t0, "start": start,
                         "launches": counts(),
                         "grad": {n: p.grad.detach().cpu() for n, p in
                                  state.model.named_parameters() if p.requires_grad},
                         "param": {n: p.detach().cpu() for n, p in
                                   state.model.named_parameters() if p.requires_grad}}
        del trainer, state
    cpu, gpu = sides["cpu"], sides[DEVICE]
    names = list(cpu["grad"])
    num = sum(float(((gpu["grad"][n].double() - cpu["grad"][n].double()) ** 2).sum())
              for n in names)
    den = sum(float((cpu["grad"][n].double() ** 2).sum()) for n in names)
    grad_rel = (num / den) ** 0.5
    scale = max(float(cpu["grad"][n].abs().max()) for n in names)
    lr = cfg.optim.lr
    sure_err, any_err = 0.0, 0.0
    for n in names:
        diff = (gpu["param"][n] - cpu["param"][n]).abs()
        sure = cpu["grad"][n].abs() >= 1e-4 * scale
        sure_err = max(sure_err, float(diff[sure].max()) if bool(sure.any()) else 0.0)
        any_err = max(any_err, float(diff.max()))
    log(f"train step V3 full width, batch 2, f32, dropout off: loss card {gpu['loss']:.6f} vs "
        f"CPU {cpu['loss']:.6f}; trainable gradient relative L2 {grad_rel:.3g}; parameters after "
        f"the step: largest difference {sure_err / lr:.4f} lr where |g| >= 1e-4 of the largest, "
        f"{any_err / lr:.3f} lr anywhere; K2 (exact, f32) launches on the card "
        f"{gpu['launches']['mha_exact']}; the step {gpu['s']:.2f} s on {card} (with its "
        f"warm-up), {cpu['s']:.1f} s on the CPU")
    check("train step, card against CPU", {
        "loss within rtol 1e-4": abs(gpu["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"]),
        "gradient within 1e-3 relative L2": grad_rel <= 1e-3,
        "parameters within lr / 100 where |g| >= 1e-4 of the largest": sure_err <= lr / 100,
        "parameters within 2 lr everywhere": any_err <= 2 * lr,
        "K2 launches 8 (f32: the exact kernel)": gpu["launches"]["mha_exact"] == 8,
    })
    return {"loss": [gpu["loss"], cpu["loss"]], "grad_rel_l2": grad_rel,
            "param_err_lr": sure_err / lr, "launches": gpu["launches"]["mha_exact"]}


def phase_training(card: str) -> dict:
    """The training entry points at full width (see the module docstring,
    phase 12). Returns the K1 and K2 launches of each training path."""
    root = os.path.join(ROOT, "build", "smoke_training")
    if os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(root)
    corpus = write_training_corpus(os.path.join(root, "corpus"), 0)
    audio = train_audio_runs(card, root, corpus)
    torch.cuda.empty_cache()
    visual = train_visual_runs(card, root)
    features = extract_features_run(card, root, audio)
    torch.cuda.empty_cache()
    detector = detector_runs(card)
    versus_cpu = step_against_cpu(card)
    v3, v1 = audio["v3"]["runs"], audio["v1"]["runs"]
    mha_tc = {
        "cli.train_audio v3 epochs 0-1 (6 steps)": v3[0]["launches"]["mha_tc"],
        "cli.train_audio v3 --resume, epoch 2 (3 steps)": v3[1]["launches"]["mha_tc"],
        f"cli.train_audio v1 7 classes ({len(v1[0]['steps'])} steps)": v1[0]["launches"]["mha_tc"],
        "cli.extract_features": features["launches"]["mha_tc"],
    }
    steps_v3 = [s for r in v3 for s in r["steps"]]
    summary = {
        "audio_v3": {"step_ms": [s["ms"] for s in steps_v3],
                     "median_step_ms": float(np.median([s["ms"] for s in steps_v3[1:]])),
                     "peak_gib": max(s["peak_gib"] for s in steps_v3),
                     "loss": [s["loss"] for s in steps_v3],
                     "mha_per_step": [s["mha"] for s in steps_v3],
                     "grad_qkv_layer11": [s["grad_qkv"] for s in steps_v3]},
        "audio_v1": {"step_ms": [s["ms"] for s in v1[0]["steps"]],
                     "peak_gib": max(s["peak_gib"] for s in v1[0]["steps"]),
                     "loss": [s["loss"] for s in v1[0]["steps"]]},
        "static": {"step_ms": [s["ms"] for s in visual["static"]["steps"]],
                   "peak_gib": max(s["peak_gib"] for s in visual["static"]["steps"]),
                   "loss": [s["loss"] for s in visual["static"]["steps"]],
                   "bn_running_change": visual["bn_running_change"]},
        "dynamic": {"step_ms": [s["ms"] for s in visual["dynamic"]["steps"]],
                    "loss": [s["loss"] for s in visual["dynamic"]["steps"]]},
        "extract_features_s": features["wall_s"],
        "detector": {k: detector[k] for k in ("train_s", "eval_s", "recall")},
        "step_against_cpu": versus_cpu,
    }
    log("training summary: " + json.dumps(summary))
    return {"mha_tc": mha_tc,
            "mha_exact": {"train step on the card against the CPU (f32)": versus_cpu["launches"]},
            "nms_mask": {"evaluate_bucket_recall (2 buckets x 8 scenes)": detector["launches"]}}


# ---------------------------------------------------------------------------
# phase 13: the parallel paths, convert_verify and its sidecar, launch_sim,
# the Keras converter
# ---------------------------------------------------------------------------

#: the parallel paths' kernel shapes: a replica's detect batch at data 2, and
#: a frozen encoder layer's tensor-parallel shard of heads at data 2 x model 2
#: (V3 batch 24: 12 rows a replica, 16 / 2 heads)
NMS_DP_SHAPE = (DETECT_BATCH // 2, 64)
ATTN_TP_SHAPE = (12, 8, 199, 64)
TRAIN_BATCH = 24
#: a parallel train step against the plain one on the card: the bf16 loss
#: (relative), and the f32 gradient (relative L2; see parallel_train_steps)
STEP_LOSS_RTOL, STEP_GRAD_F32 = 5e-3, 2e-2
#: the data-parallel clip against the same pipeline at N = 1 (bf16): the CNN's
#: 256 crops run as 2 x 128, which cuDNN may sum in another order
DP_PROB_ATOL = 5e-2


def parallel_kernel_entries(card: str) -> list[dict]:
    """K1 at a replica's ``[16, 64, 4]`` and K2 (bf16, the tensor-core
    kernel) at the tensor-parallel shard ``[12, 8, 199, 64]``, each against
    its plain version, timed beside it and the library call, with the bound
    of these inputs."""
    dev = torch.device("cuda")
    boxes, valid = nms_case(7, *NMS_DP_SHAPE)
    bt, vt = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    keep = nms_kernel.nms_mask(bt, vt, 0.4)
    if not torch.equal(keep, nms_kernel.nms_mask_plain(bt, vt, 0.4)):
        raise AssertionError(f"nms kernel: keep masks differ at {list(bt.shape)}")
    nms = nms_numbers(bt, vt, keep)
    log(f"kernel nms_mask (a replica's detect batch at data 2) {nms['shape']}: keep masks equal; "
        f"{nms['ms']:.4f} ms a call (median of 50), device time {ms_text(nms['device_ms'])}, vs "
        f"plain {nms['plain_ms']:.4f} ms, bound {nms['bound_ms']:.6f} ms ({nms['bound_by']}), no "
        f"library call, on {card}")
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=ATTN_TP_SHAPE).astype(np.float32)).to(dev)
               .bfloat16() for _ in range(3))
    mha, plain = attention_kernel.mha, attention_kernel.mha_plain
    ran = mha_kernels_of(lambda: mha(q, k, v))
    got = mha(q, k, v).float()
    want = plain(q.float(), k.float(), v.float())
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=4e-3)
    if ran != {"tc": 1}:
        raise AssertionError(f"mha routed the bf16 shard to {ran}")
    ms = median_ms(lambda: mha(q, k, v))
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    plain_ms = median_ms(lambda: plain(q, k, v))
    dev_ms = device_ms(lambda: mha(q, k, v))
    b, h, t, d = ATTN_TP_SHAPE
    bound, by = bound_ms(4 * tensor_bytes(q), 4.0 * b * h * t * t * d, "bf16")
    log(f"kernel mha_tc (a tensor-parallel shard of heads) {list(ATTN_TP_SHAPE)} bf16: max abs "
        f"err {err:.3g} vs f32 plain (atol 1e-5, rtol 4e-3); {ms:.4f} ms vs plain {plain_ms:.4f} "
        f"ms, scaled_dot_product_attention {lib_ms:.4f} ms (a call, median of 50); device time "
        f"{ms_text(dev_ms)}; bound {bound:.4f} ms ({by}) on {card}")
    return [
        entry("nms_mask_dp", "nms.cu", "avcer_tpu/ops/pallas/nms_kernel.py:62", max_abs_err=0.0,
              library_ms=None, held_as=["nms_mask", nms["shape"]], **nms),
        entry("mha_tc_tp", "attention.cu", "avcer_tpu/ops/pallas/attention_kernel.py:40",
              max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
              library_ms=lib_ms, shape=list(ATTN_TP_SHAPE), dtype="bf16", device_ms=dev_ms,
              held_as=["mha_tc", list(ATTN_TP_SHAPE)]),
    ]


def held_run(label: str, fn):
    """``fn()`` with every distinct kernel call it makes held against the
    kernel's plain version (a fresh record: calls the earlier phases held are
    held again), its launches counted from 0; returns (result, launches,
    wall s, the held calls)."""
    seen: dict = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with holding_new_calls(seen):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    HELD.update(seen)
    log(f"{label}: {wall:.2f} s, launches {launches}, {len(seen)} distinct kernel calls held: "
        + ", ".join(sorted({name for name, _ in seen.values()})))
    return out, launches, wall, seen


def dp_serving(card: str, frames: np.ndarray, wav: np.ndarray, ref_clip) -> dict:
    """``parity`` over a data-parallel mesh of 2 (the card named twice:
    NCCL refuses two ranks on one GPU, and gloo takes CUDA tensors only for
    all-reduce and broadcast, so the smoke runs one process over a mesh that
    names the card twice): a warm-up run with every distinct K1 and K2 call
    held, then a timed run with its launches counted, against the same
    pipeline at N = 1 (``ref_clip``): compound decisions (95 % required), the
    static probabilities and dynamic logits within ``DP_PROB_ATOL``, the
    audio logits equal (the audio stage does not shard)."""
    cfg = dataclasses.replace(smoke_config("bfloat16"), mesh=MeshConfig(data=2))
    pipe = build(card, False, cfg=cfg, label="parity, data parallel 2 (the card twice)",
                 mesh_devices=[DEVICE] * 2)
    if len(pipe.detect.inner.replicas) != 2 or pipe.detect.inner.model.fused_ssh:
        raise AssertionError("data-parallel build: expected 2 detect replicas, fused off")
    held_run("parity data parallel 2, warm-up run",
             lambda: pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clip = pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, counts()
    agreement(clip, ref_clip, "parity data parallel 2 vs N = 1", 0.95)
    diffs = {key: float(np.abs(getattr(clip, key) - getattr(ref_clip, key)).max())
             for key in ("stat_probs", "dyn_logits", "audio_window_logits")}
    batches = -(-frames.shape[0] // DETECT_BATCH)
    check("parity data parallel 2", {
        f"K1 launches 2 a detect batch ({2 * batches})": launches["nms_mask"] == 2 * batches,
        "K2 launches > 0, all in the tensor-core kernel":
            launches["mha"] > 0 and launches["mha_tc"] == launches["mha"],
        f"static probabilities within {DP_PROB_ATOL}": diffs["stat_probs"] <= DP_PROB_ATOL,
        f"dynamic logits within {DP_PROB_ATOL} x their largest magnitude":
            diffs["dyn_logits"] <= DP_PROB_ATOL * max(1.0, float(np.abs(ref_clip.dyn_logits).max())),
        "audio logits equal": diffs["audio_window_logits"] == 0.0,
    })
    log(f"parity data parallel 2 vs N = 1: largest differences {diffs}; wall {wall:.3f} s "
        f"({CLIP_SECONDS / wall:.3f} video-sec/sec) on {card}")
    del pipe
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall, "diffs": diffs}


def grad_rel_l2(got: dict, want: dict) -> float:
    """|got - want| / |want| over every trainable gradient as one vector."""
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum()) for n in want)
    den = sum(float((want[n].double() ** 2).sum()) for n in want)
    return (num / den) ** 0.5


def parallel_train_steps(card: str) -> dict:
    """One V3 train step at full width (wav2vec2-large, 12 layers, the last 4
    trained, batch 24 of 4 s, REMAT, dropout off, no mixup) plain, at data 2
    x model 2 and at pipe 2 (2 microbatches) over the card named 4 and 2
    times, all from the same seeded weights, in f32 and in bf16 under
    autocast. The seeded model's gradient is ill-conditioned: nudging every
    input sample by one f32 ulp moves it by ``cond32`` (relative L2, measured
    here with one more plain f32 step), and a sharded step changes the
    card's kernels (batch sizes, split products), so its f32 gradient is held
    within ``STEP_GRAD_F32`` of the plain step's (a shard's gradient lost or
    counted twice moves it by tens of percent), its loss within rtol 1e-5.
    bf16: the loss within rtol 5e-3, the gradient within 1.5 times the
    distance ``noise16`` of the plain bf16 step from the plain f32 one. The
    CPU tests hold the same steps to 5e-4 of the plain step and of the JAX
    trainer's. K2's launches per path (a frozen layer's attention a data
    row, model shard and microbatch: 8, 32, 16), in f32 on the exact kernel,
    in bf16 on the tensor-core kernel; every distinct call held."""
    from avcer_tpu_torch.core.config import TrainConfig
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from avcer_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(TRAIN_BATCH, 4 * TRAIN_SR)) * 0.5).astype(np.float32)
    y = rng.integers(0, 8, TRAIN_BATCH)
    up = rng.random(x.shape) < 0.5
    nudged = np.where(up, np.nextafter(x, np.inf), np.nextafter(x, -np.inf)).astype(np.float32)
    seeded = ExprModel("v3", 8, Wav2Vec2Config(remat=True))
    layers.seeded_init_(seeded, torch.Generator().manual_seed(0))
    start = seeded.state_dict()
    del seeded
    paths = {"plain": (MeshConfig(), None, 8),
             "data 2 x model 2": (MeshConfig(data=2, model=2), [DEVICE] * 4, 8 * 2 * 2),
             "pipe 2, 2 microbatches": (MeshConfig(pipe=2, pipe_microbatches=2), [DEVICE] * 2,
                                        8 * 2)}
    runs = [(dtype, kernel, name, spec, x) for dtype, kernel in
            (("float32", "mha_exact"), ("bfloat16", "mha_tc")) for name, spec in paths.items()]
    runs.append(("float32", "mha_exact", "plain, inputs nudged by one ulp", paths["plain"],
                 nudged))
    out: dict = {}
    for dtype, kernel, name, (mesh, devices, want_k2), inputs in runs:
        cfg = TrainConfig(batch_size=TRAIN_BATCH, augmentation=False, mesh=mesh,
                          log_root=os.path.join(ROOT, "build", "smoke_parallel", "logs"))
        trainer = Trainer(ExprModel("v3", 8, Wav2Vec2Config(remat=True)), cfg,
                          iters_per_epoch=3, device=DEVICE, devices=devices, dtype=dtype)
        state = trainer.init_state(params=start)
        for rep in trainer.replicas:
            layers.set_dropout(rep, p=0.0)
        torch.cuda.reset_peak_memory_stats()
        (state, loss, _), launches, wall, _ = held_run(
            f"V3 train step, {name}, {dtype}", lambda: trainer.train_step(state, inputs, y))
        out[dtype, name] = {"loss": loss, "s": wall, "launches": launches[kernel],
                            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                            "grad": {n: p.grad.detach().float().cpu() for n, p in
                                     state.model.named_parameters() if p.requires_grad}}
        check(f"V3 train step, {name}, {dtype}", {
            f"K2 launches {want_k2}, all in {kernel}":
                launches["mha"] == want_k2 == launches[kernel]})
        del trainer, state
        torch.cuda.empty_cache()
    cond32 = grad_rel_l2(out["float32", "plain, inputs nudged by one ulp"]["grad"],
                         out["float32", "plain"]["grad"])
    noise16 = grad_rel_l2(out["bfloat16", "plain"]["grad"], out["float32", "plain"]["grad"])
    log(f"V3 train step, the plain gradient's own spread (relative L2): inputs nudged by one "
        f"f32 ulp {cond32:.3g}; bf16 against f32 {noise16:.3g}")
    summary = {"f32_one_ulp_input_grad_rel_l2": cond32, "bf16_vs_f32_grad_rel_l2": noise16}
    for (dtype, name), side in out.items():
        ref = out[dtype, "plain"]
        grad_rel = grad_rel_l2(side["grad"], ref["grad"])
        loss_rel = abs(side["loss"] - ref["loss"]) / abs(ref["loss"])
        summary[f"{name}, {dtype}"] = {"loss": side["loss"], "loss_rel": loss_rel,
                                       "grad_rel_l2": grad_rel, "step_s": side["s"],
                                       "peak_gib": side["peak_gib"], "k2": side["launches"]}
        log(f"V3 train step {name}, {dtype}: loss {side['loss']:.6f} (relative to plain "
            f"{loss_rel:.3g}), trainable gradient relative L2 to plain {grad_rel:.3g}, step "
            f"{side['s']:.2f} s (first step of its trainer), peak {side['peak_gib']:.2f} GiB, "
            f"K2 launches {side['launches']} on {card}")
        if name.startswith("plain"):
            continue
        if dtype == "float32":
            checks = {"loss within rtol 1e-5": loss_rel <= 1e-5,
                      f"gradient within {STEP_GRAD_F32} relative L2": grad_rel <= STEP_GRAD_F32}
        else:
            checks = {f"loss within rtol {STEP_LOSS_RTOL}": loss_rel <= STEP_LOSS_RTOL,
                      f"gradient within 1.5 x {noise16:.3g} relative L2":
                          grad_rel <= 1.5 * noise16}
        check(f"V3 train step {name}, {dtype}, against plain", checks)
    return summary


def convert_verify_and_sidecar(card: str, frames: np.ndarray, wav: np.ndarray,
                               release_dir: str) -> dict:
    """``python -m avcer_tpu_torch.cli.convert_verify --weights_dir W
    --calib_video clip --golden`` on the release written from the seeded
    models (exit 0; every family present ``ok``, the sidecars written, the
    golden artifacts), every distinct kernel call held; then ``int8
    --fused`` built from W: the sidecars adopted at build (no calibration
    forward left for the clip), and a run with every distinct K3 and K4 int8
    call held."""
    from avcer_tpu_torch.cli import convert_verify

    clip_dir = os.path.join(ROOT, "build", "smoke_parallel")
    os.makedirs(clip_dir, exist_ok=True)
    video = os.path.join(clip_dir, "calib.avi")
    write_video(video, frames[:4 * FPS])
    write_wav(os.path.join(clip_dir, "calib.wav"), wav[:4 * 16000], 16000)
    shutil.rmtree(os.path.join(release_dir, "torch"), ignore_errors=True)
    (rc, stdout, wall), cv_launches, _, _ = held_run(
        "cli.convert_verify --calib_video --golden",
        lambda: run_cli(convert_verify.main, ["--weights_dir", release_dir, "--calib_video",
                                              video, "--golden"]))
    report = json.loads(stdout.strip().splitlines()[-1])
    present = [f for f in convert_verify.FAMILIES if report[f]["status"] != "missing"]
    check("cli.convert_verify", {
        "exit code 0": rc == 0,
        "four families present, each ok": len(present) == 4 and all(
            report[f]["status"] == "ok" for f in present),
        "three sidecars written": sorted(report["calibration"]["persisted"]) == sorted(
            ["retinaface", "emotion_resnet50", "expr_model_8cl"]),
        "golden run ok with the reference's artifacts": report["golden"]["status"] == "ok"
            and any(a.startswith("static__") for a in report["golden"]["artifacts"]),
        "K1 and K2 launched": cv_launches["nms_mask"] > 0 and cv_launches["mha"] > 0,
    })
    log(f"cli.convert_verify: {wall:.2f} s; report {json.dumps(report)[:2000]}")

    cfg = dataclasses.replace(preset_config("int8", fused=True), weights_dir=release_dir)
    pipe = build(card, True, cfg=cfg, label="int8 --fused from the release and its sidecars")
    adopted = {"detect": pipe.detect.inner._real_calibrated,
               "visual": pipe.visual._real_calibrated, "audio": pipe.audio._real_calibrated}
    side = checkpoint.load_act_scales(release_dir, "emotion_resnet50")
    now = layers.act_scales(pipe.visual.static_model)
    grown = all(float(now[k]) >= float(side[k]) for k in side)
    before = calibration_forwards(pipe)
    clip, int8_launches, _, seen = held_run(
        "int8 --fused from the sidecars, warm-up run",
        lambda: pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav))
    held = {name for name, _ in seen.values()}
    check("int8 --fused from the sidecars", {
        "sidecars adopted at build by all three stages": all(adopted.values()),
        "CNN scales at least the sidecar's": grown,
        "no calibration forward in the run": calibration_forwards(pipe) == before,
        "K3 and K4 int8 held": {"fused_chain_int8", "fused_ssh_heads_int8"} <= held,
        "finite outputs": bool(np.isfinite(clip.stat_probs).all()),
    })
    del pipe
    torch.cuda.empty_cache()
    return {"convert_verify": cv_launches, "int8_launches": int8_launches}


def launch_sim_run() -> dict:
    """``python -m avcer_tpu_torch.parallel.launch_sim --processes 2`` on the
    host's CPU over gloo, as the JAX module runs on virtual CPU devices."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "avcer_tpu_torch.parallel.launch_sim",
                           "--processes", "2"], capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launch_sim exited {proc.returncode}: {proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"launch_sim --processes 2 (gloo, CPU): {summary} in {wall:.2f} s")
    check("launch_sim", {"ok, the processes' losses agree": summary["ok"]})
    return summary


def keras_phase(card: str) -> None:
    """The Keras LSTM converter on an ``.h5`` written from a seeded
    ``TemporalLSTM`` in the Keras layout, the converted model on the card
    against the original (atol 1e-4, rtol 1e-3). Runs only where h5py is
    installed; it is a host-side reader, held on the CPU by the tests."""
    import importlib.util

    if importlib.util.find_spec("h5py") is None:
        log("Keras phase not run: h5py is not installed on this machine (the converter is "
            "host numpy, held against the JAX package's by tests/test_torch_convert_verify.py)")
        return
    import h5py

    from avcer_tpu_torch.core.convert_keras import convert_keras_lstm
    from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM

    src = TemporalLSTM(7)
    layers.seeded_init_(src, torch.Generator().manual_seed(4))
    path = os.path.join(ROOT, "build", "smoke_parallel", "lstm.h5")
    with h5py.File(path, "w") as f:
        names = []
        for i, lname in enumerate(["lstm", "lstm_1"]):
            m = getattr(src, f"lstm{i + 1}")
            g = f.create_group(lname)
            wn = [f"{lname}/lstm_cell/{w}:0" for w in ("kernel", "recurrent_kernel", "bias")]
            g.attrs["weight_names"] = [n.encode() for n in wn]
            g.create_dataset(wn[0], data=m.weight_ih_l0.detach().numpy().T)
            g.create_dataset(wn[1], data=m.weight_hh_l0.detach().numpy().T)
            g.create_dataset(wn[2], data=(m.bias_ih_l0 + m.bias_hh_l0).detach().numpy())
            names.append(lname.encode())
        g = f.create_group("dense")
        g.attrs["weight_names"] = [b"dense/kernel:0", b"dense/bias:0"]
        g.create_dataset("dense/kernel:0", data=src.fc.weight.detach().numpy().T)
        g.create_dataset("dense/bias:0", data=src.fc.bias.detach().numpy())
        f.attrs["layer_names"] = names + [b"dense"]
    model = TemporalLSTM(7)
    model.load_state_dict(convert_keras_lstm(path), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 10, 512)).astype(np.float32))
    with torch.no_grad():
        got = model.to(DEVICE).eval()(x.to(DEVICE)).cpu()
        want = src.eval()(x)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    log(f"Keras LSTM .h5 -> TemporalLSTM on {card}: max abs err {err:.3g} against the source "
        "model on the CPU (atol 1e-4, rtol 1e-3)")


def phase_parallel(card: str, frames: np.ndarray, wav: np.ndarray, ref_clip,
                   release_dir: str) -> dict:
    """Phase 13 (see the module docstring). Returns the launches of each
    parallel path by kernel entry."""
    t0 = time.perf_counter()
    serving = dp_serving(card, frames, wav, ref_clip)
    t1 = time.perf_counter()
    steps = parallel_train_steps(card)
    t2 = time.perf_counter()
    cv = convert_verify_and_sidecar(card, frames, wav, release_dir)
    t3 = time.perf_counter()
    sim = launch_sim_run()
    keras_phase(card)
    t4 = time.perf_counter()
    log(f"phase 13: data-parallel serving {t1 - t0:.2f} s, parallel train steps {t2 - t1:.2f} s, "
        f"convert_verify and int8 from its sidecars {t3 - t2:.2f} s, launch_sim and Keras "
        f"{t4 - t3:.2f} s")
    log("parallel summary: " + json.dumps({"serving": {k: serving[k] for k in ("wall_s", "diffs")},
                                           "train_steps": steps, "launch_sim": sim}))
    by_path = {
        "nms_mask": {"parity --data_parallel 2 (a run)": serving["launches"]["nms_mask"],
                     "convert_verify --calib_video --golden": cv["convert_verify"]["nms_mask"]},
        "mha_tc": {"parity --data_parallel 2 (a run)": serving["launches"]["mha_tc"],
                   "convert_verify --calib_video --golden": cv["convert_verify"]["mha_tc"],
                   **{f"V3 train step, {k}": v["k2"] for k, v in steps.items()
                      if k.endswith("bfloat16")}},
        "mha_exact": {f"V3 train step, {k}": v["k2"] for k, v in steps.items()
                      if k.endswith("float32")},
        "fused_chain_int8": {"int8 --fused from the sidecars (a run)":
                             cv["int8_launches"]["fused_chain"]},
        "fused_ssh_heads_int8": {"int8 --fused from the sidecars (a run)":
                                 cv["int8_launches"]["fused_ssh_heads"]},
    }
    by_path["nms_mask_dp"] = {"parity --data_parallel 2 (a run)":
                              serving["launches"]["nms_mask"]}
    by_path["mha_tc_tp"] = {"V3 train step, data 2 x model 2, bf16":
                            steps["data 2 x model 2, bfloat16"]["k2"]}
    if min(v for d in by_path.values() for v in d.values()) <= 0:
        raise AssertionError(f"parallel paths without their kernels: {by_path}")
    return by_path


def held_entries(kernels: list[dict]) -> None:
    """Each kernels entry's calls held on the main paths (``HELD``) and their
    largest error; an entry launched on a path but held at none raises."""
    for k in kernels:
        name, shape = k.get("held_as", (k["name"], None))
        errs = [err for key, (held, err) in HELD.items() if held == name
                and (shape is None or list(key[1][0][0]) == list(shape))]
        k["path_calls_held"] = len(errs)
        k["path_max_abs_err"] = max(errs, default=None)
        if k["launches"] and not errs:
            raise AssertionError(f"{k['name']}: launched on a main path, held at none of its calls")
    log(f"{len(HELD)} distinct kernel calls of the main paths held against their plain versions: "
        + ", ".join(f"{k['name']} {k['path_calls_held']}" for k in kernels))


def main() -> int:
    card = phase_device()
    phase_build()
    if sys.argv[1:] == ["--phase", "training"]:
        phase_training(card)
        return 0
    if sys.argv[1:] == ["--phase", "wavlm"]:
        frames, wav = make_clip()
        bias_entry = kernels_mha_bias(card)
        phase_wavlm(card, frames, wav, bias_entry)
        held_entries([bias_entry])
        print(json.dumps({"kernels": [bias_entry]}))
        return 0
    if sys.argv[1:] == ["--phase", "parallel"]:
        frames, wav = make_clip()
        pipe = build(card, False)
        clip, _ = phase_main(card, pipe, False, frames, wav, timed_runs=1)
        release = os.path.join(ROOT, "build", "smoke_release")
        write_release(build_pipeline(smoke_config("float32"), device="cpu", seed=0), release)
        del pipe
        torch.cuda.empty_cache()
        parallel_kernel_entries(card)
        phase_parallel(card, frames, wav, clip, release)
        return 0
    pipe, fused_pipe = build(card, False), build(card, True)
    int8_pipe, int8_fused_pipe = build(card, False, True), build(card, True, True)
    frames, wav = make_clip()
    bias_entry = kernels_mha_bias(card)
    kernels = (phase_kernels(card, fused_pipe, int8_fused_pipe) + [bias_entry]
               + [kernels_i420(card, frames)] + parallel_kernel_entries(card))
    mobilenet_kernels = phase_kernels_mobilenet(card)
    int8_modules(card)
    ref = phase_reference(pipe, fused_pipe, frames, wav)
    phase_reference_int8(int8_pipe, int8_fused_pipe, frames, wav)
    clip, _ = phase_main(card, pipe, False, frames, wav, profile=True)
    phase_plain_route(pipe, frames, wav, clip, "parity")
    phase_wire_formats(card, pipe, frames, wav, clip)
    fused_clip, launches = phase_main(card, fused_pipe, True, frames, wav)
    phase_wavlm(card, frames, wav, bias_entry)
    # one timed run: int8 unfused is launch-bound and holds no kernel of its own
    int8_clip, _ = phase_main(card, int8_pipe, False, frames, wav, int8=True, timed_runs=1)
    int8_fused_clip, int8_launches = phase_main(card, int8_fused_pipe, True, frames, wav,
                                                int8=True, profile=True)
    phase_plain_route(int8_fused_pipe, frames, wav, int8_fused_clip, "int8 --fused")
    for k in kernels:
        if k["name"].endswith("_int8"):  # the same wrapper, counted in the int8 fused run
            k["launches"] = int8_launches[k["name"][:-len("_int8")]]
        elif k["name"] in launches:
            k["launches"] = launches[k["name"]]
    agreement(fused_clip, clip, "fused vs unfused", 0.95)
    agreement(int8_fused_clip, int8_clip, "int8 fused vs int8 unfused", 0.80)
    # int8 against bf16 is another arithmetic (1e-2 in a probability): reported
    agreement(int8_clip, clip, "int8 vs bf16 (unfused)", 0.0)
    agreement(int8_fused_clip, fused_clip, "int8 fused vs bf16 fused", 0.0)
    t0 = time.perf_counter()
    phase_calibrate(card, frames, wav, clip)
    phase_build_cache(card, frames, wav)
    log(f"calibrate and build-cache phases: {time.perf_counter() - t0:.2f} s")
    release_build_s = phase_release(card, ref, fused_pipe, frames, wav)
    del pipe, fused_pipe, int8_pipe, int8_fused_pipe, ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    surface_launches = phase_surface(card, frames, wav)
    for k in kernels:
        if k["name"] in ("nms_mask", "fused_chain"):
            k["launches_by_surface_path"] = {t: n[k["name"]] for t, n in surface_launches.items()}
    log(f"release and surface phases: build from release files {release_build_s:.2f} s, "
        f"surface paths {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    c64_launches = phase_presets(card, frames, wav, int8_clip)
    # no entry point serves the mobilenet detector exact: the bf16 mode at
    # C = 64 is held in the kernels and reference phases only and keeps 0
    # launches; the int8 mode's entry times the 640 bucket's shapes, which
    # fast --fused gives it
    c64, c64_int8 = mobilenet_kernels
    c64["on_main_path"] = False
    c64_int8["launches"] = c64_launches["fast --fused"]
    c64_int8["launches_by_path"] = c64_launches
    if min(c64_launches.values()) <= 0:
        raise AssertionError(f"fused_ssh_heads int8 at C = 64: launches {c64_launches}")
    t0 = time.perf_counter()
    phase_offline_eval(card, frames, wav)
    log(f"offline evaluation phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_preprocess(card, wav)
    log(f"preprocessing phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    s3fd = phase_s3fd(card, frames)
    log(f"S3FD and detect_demo phase: {time.perf_counter() - t0:.2f} s")
    nms = next(k for k in kernels if k["name"] == "nms_mask")
    nms["launches_by_path"] = s3fd["launches_by_path"]
    nms["s3fd_mode"] = s3fd["s3fd_mode"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training = phase_training(card)
    log(f"training phase: {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        if k["name"] in ("nms_mask", "mha_tc", "mha_exact"):
            k["launches_by_training_path"] = training[k["name"]]
    if min(training["mha_tc"].values()) <= 0 or min(training["nms_mask"].values()) <= 0:
        raise AssertionError(f"training paths without their kernels: {training}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parallel = phase_parallel(card, frames, wav, clip, os.path.join(ROOT, "build",
                                                                     "smoke_release"))
    log(f"parallel phase: {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        if k["name"] in parallel:
            k["launches_by_parallel_path"] = parallel[k["name"]]
        if k["name"] in ("nms_mask_dp", "mha_tc_tp"):  # their only paths are the parallel ones
            k["launches"] = sum(parallel[k["name"]].values())
    i420 = next(k for k in kernels if k["name"] == "i420_to_bgr")
    i420["launches_by_path"] = {label: n["i420_to_bgr"] for label, n in PATH_LAUNCHES.items()}
    i420["device_ms_a_launch_by_profiled_path"] = I420_TRACED
    held_entries(kernels + mobilenet_kernels)
    print(json.dumps({"kernels": kernels + mobilenet_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
