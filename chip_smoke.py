#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (avcer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the four CUDA sources from csrc/ with nvcc (sm_90a), all
   at once, and prints each one's build time, registers and spills;
3. pipelines: the full-width audio-visual pipeline (RetinaFace-r50 @640,
   EmotionResNet50, LSTM, wav2vec2-large 12 layers + ExprModel V3, bf16,
   seeded weights) built four times: unfused and with the seven fused
   switches, each exact and in int8 (``cli.run --serving_profile int8``:
   calibrated static activation scales, the shared audio extractor);
4. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (NMS keep masks equal; attention, fused_chain and
   fused_ssh_heads, exact and in their int8 modes, and fused_chain_flat
   within the stated tolerances, f32 and bf16), with median times over 50
   runs of the kernel, its plain version and, where there is one, a library
   yardstick (scaled_dot_product_attention; the port's own unfused section
   for the fused kernels: cuDNN, or in int8 torch._int_mm), and the roofline
   bound computed from the inputs;
5. reference: each model's output on the card (bf16, kernels), unfused and
   fused, exact and int8, against the same seeded weights (and the same
   activation scales) in f32 on the CPU (plain versions), on a small input;
6. main path, four times: unfused, fused (``cli.run --fused``), int8 unfused
   and int8 fused (``--serving_profile int8 [--fused]``): an 8 s synthetic
   640x360 clip and a 16 kHz wav: one warm-up run (in int8 it also refines
   the scales, which then stay frozen), then three timed runs, each with its
   outputs and the launch counts of the kernels checked; the fused runs'
   compound decisions against the unfused runs'.

Prints a JSON line of kernel results, then, last, one JSON object with the
device. Imports nothing of JAX and nothing of the JAX package.
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

import torch.nn.functional as F  # noqa: E402

from avcer_tpu_torch import _build  # noqa: E402
from avcer_tpu_torch.core.config import (AudioConfig, DetectorConfig,  # noqa: E402
                                         PipelineConfig, VisualConfig)
from avcer_tpu_torch.models import layers  # noqa: E402
from avcer_tpu_torch.models.retinaface import fold_pairs, nhwc, upsample_nearest_to  # noqa: E402
from avcer_tpu_torch.ops.cuda import (attention_kernel, fused_resnet_kernel,  # noqa: E402
                                      fused_ssh_kernel, nms_kernel)
from avcer_tpu_torch.pipeline.builder import build_pipeline  # noqa: E402
from avcer_tpu_torch.pipeline.media import ArrayReader  # noqa: E402

CLIP_SECONDS, FPS, WIDTH, HEIGHT = 8, 25, 640, 360
NMS_SHAPE = (32, 64)  # detector batch, candidates per frame
ATTN_SHAPE = (16, 16, 199, 64)  # audio batch, heads, frames of a 4 s window, head dim
TIMED_RUNS = 3  # after one warm-up run; the host's clock varies from run to run
DETECT_BATCH, CNN_BATCH, AUDIO_BATCH = 32, 256, 16
#: NVIDIA H100 SXM data sheet: dense bf16 and int8 on the tensor cores, f32 on
#: the CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
WRAPPERS = {"nms_mask": nms_kernel.nms_mask, "mha": attention_kernel.mha,
            "fused_chain": fused_resnet_kernel.fused_chain,
            "fused_ssh_heads": fused_ssh_kernel.fused_ssh_heads,
            "fused_chain_flat": fused_resnet_kernel.fused_chain_flat}


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
    nms_ms = median_ms(lambda: nms_kernel.nms_mask(bt, vt, 0.4))
    nms_plain_ms = median_ms(lambda: nms_kernel.nms_mask_plain(bt, vt, 0.4))
    # work of this run's data: row i is compared with the K - 1 - i rows after
    # it only while it is kept: about 20 f32 operations a pair
    pairs = float(((NMS_SHAPE[1] - 1 - torch.arange(NMS_SHAPE[1], device=dev)) * got).sum())
    nms_bound, nms_by = bound_ms(tensor_bytes(bt, vt, got), 20 * pairs, "f32")
    log(f"kernel nms_mask [{NMS_SHAPE[0]}, {NMS_SHAPE[1]}, 4]: keep masks equal over 4 seeds; "
        f"{nms_ms:.4f} ms vs plain {nms_plain_ms:.4f} ms (median of 50), bound "
        f"{nms_bound:.6f} ms ({nms_by}), no library call, on {card}")

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
    attn_lib_ms = median_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb))
    b, h, t, d = ATTN_SHAPE
    attn_bound, attn_by = bound_ms(4 * tensor_bytes(qb), 4.0 * b * h * t * t * d, "bf16")
    log(f"kernel mha {list(ATTN_SHAPE)}: f32 max abs err {err32:.3g} (atol 2e-5, rtol 1e-4); "
        f"bf16 max abs err {err16:.3g} vs f32 plain (atol 1e-5, rtol 4e-3); "
        f"bf16 {attn_ms:.4f} ms vs plain {attn_plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {attn_lib_ms:.4f} ms (median of 50), bound "
        f"{attn_bound:.4f} ms ({attn_by}) on {card}")
    return [
        entry("nms_mask", "nms.cu", "avcer_tpu/ops/pallas/nms_kernel.py:62",
              max_abs_err=float(mismatches), ms=nms_ms, plain_ms=nms_plain_ms,
              bound_ms=nms_bound, bound_by=nms_by, library_ms=None),
        entry("mha", "attention.cu", "avcer_tpu/ops/pallas/attention_kernel.py:40",
              max_abs_err=err16, ms=attn_ms, plain_ms=attn_plain_ms, bound_ms=attn_bound,
              bound_by=attn_by, library_ms=attn_lib_ms),
    ]


def randn(shape, seed: int, dtype=torch.bfloat16, relu: bool = True) -> torch.Tensor:
    """Activations as a ReLU leaves them, made from a seed with numpy."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    x = torch.from_numpy(x).to("cuda")
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
    body = detector.body
    return [
        ("detector layer1", body.layer1, [0, 1, 2], ("ds", "id", "id"), (DETECT_BATCH, 90, 160, 64)),
        ("detector layer2", body.layer2, [0, 1, 2, 3], ("s2ds", "id", "id", "id"),
         (DETECT_BATCH, 90, 160, 256)),
        ("detector layer3 entry", body.layer3, [0, 1], ("s2ds", "id"), (DETECT_BATCH, 45, 80, 512)),
        ("detector layer3 tail", body.layer3, [2, 3, 4], ("id", "id", "id"),
         (DETECT_BATCH, 23, 40, 1024)),
        ("emotion layer2", emotion.layer2, [0, 1, 2], ("s2pre", "id", "id"),
         (CNN_BATCH, 55, 55, 256)),
        ("emotion layer4 tail", emotion.layer4, [1], ("id",), (CNN_BATCH, 7, 7, 2048)),
    ]


def kernels_fused_chain(card: str, detector, emotion, quant: bool = False) -> dict:
    """K3 at the block patterns and widths of the two models, with the models'
    own (seeded) weights; the library yardstick is the same blocks unfused:
    cuDNN (channels-last bf16 convolutions and the port's BatchNorm) or, with
    ``quant`` (the int8 models, their seeded scales), the port's int8 section
    (``torch._int_mm`` over the unfolded input)."""
    rows, worst = [], 0.0
    name = "fused_chain int8" if quant else "fused_chain"
    kind = "int8" if quant else "bf16"
    for seed, (label, layer, chunk, blocks, shape) in enumerate(chain_cases(detector, emotion)):
        x = randn(shape, 100 + seed)
        pairs = [p for bi in chunk for p in layer[bi].fold_pairs()]
        # the int8 fold does not depend on the compute dtype: f32 mult and shift
        folded = {dt: fold_pairs(pairs, dt) for dt in (torch.float32, torch.bfloat16)}
        section = torch.nn.Sequential(*[layer[bi] for bi in chunk])
        x_cl = x.permute(0, 3, 1, 2)  # NCHW-shaped, channels-last in memory
        case = f"{label} {blocks} {list(shape)}"

        def run(a, dt, fn=fused_resnet_kernel.fused_chain):
            w, act_s = folded[dt]
            return (fn(a, w, blocks, act_s=act_s),)

        def run_plain(a, dt):
            return run(a, dt, fused_resnet_kernel.fused_chain_plain)

        worst = max(worst, check_fused(name, run, run_plain, x,
                                       INT8_TOL if quant else dict(atol=2e-4, rtol=1e-3), case))
        with torch.inference_mode():
            lib = section(x_cl).permute(0, 2, 3, 1)
            out = run(x, torch.bfloat16)[0]
            lib_rel = rel_l2(out, lib)
            ms = median_ms(lambda: run(x, torch.bfloat16))
            # the int8 plain version multiplies in float64: fewer timed runs
            plain = median_ms(lambda: run_plain(x, torch.bfloat16), runs=10 if quant else 50)
            lib_ms = median_ms(lambda: section(x_cl))
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
                     "plain_ms": plain, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
    first = rows[0]
    return entry("fused_chain_int8" if quant else "fused_chain", "fused_resnet.cu",
                 "avcer_tpu/ops/pallas/fused_resnet_kernel.py:" + ("219" if quant else "299"),
                 max_abs_err=worst, ms=first["ms"], plain_ms=first["plain_ms"],
                 bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                 library_ms=first["library_ms"], shape=first["shape"], cases=rows)


def kernels_fused_ssh(card: str, detector, quant: bool = False) -> dict:
    """K4 at the three scales in the fully fused order (scale 3 emits its
    lateral, scale 2 its merged feature, ``up`` the nearest upsample of the
    coarser one) and once with fused_ssh alone (scale 1 after the unfused
    FPN). The library yardstick is the port's FPN lateral and merge, SSH
    module and heads for that scale, unfused: cuDNN or, with ``quant``, the
    int8 modules."""
    shapes = [(DETECT_BATCH, 45, 80, 512), (DETECT_BATCH, 23, 40, 1024),
              (DETECT_BATCH, 12, 20, 2048)]
    folded = {dt: [detector._scale_folded(i, dt) for i in range(3)]
              for dt in (torch.float32, torch.bfloat16)}
    heads_of = [(detector.BboxHead[i], detector.ClassHead[i], detector.LandmarkHead[i])
                for i in range(3)]
    name = "fused_ssh_heads int8" if quant else "fused_ssh_heads"
    kind = "int8" if quant else "bf16"
    rows, worst = [], 0.0
    feat_prev = None
    for i in (2, 1, 0, "ssh alone"):
        alone = i == "ssh alone"
        i = 0 if alone else i
        x = randn(shapes[i][:3] + (256,), 200, relu=True) if alone else randn(shapes[i], 200 + i)
        up = None
        if feat_prev is not None and not alone:
            up = nhwc(upsample_nearest_to(feat_prev.permute(0, 3, 1, 2), x.shape[1:3]))
        emit = i > 0 and not alone

        def args(dt, n=None):
            convs, heads, lat, merge, scales = folded[dt][i]
            u = None if up is None else up[:n].to(dt)
            act_s = None
            if scales is not None:  # the kernel's order: lateral, merge, the SSH convs
                act_s = scales[2] if alone else torch.cat([sx for sx in scales if sx is not None])
            return dict(conv_folded=convs, head_folded=heads, leaky=0.0,
                        fpn_lat=None if alone else lat, fpn_merge=None if alone else merge,
                        up=u, emit_feature=emit, act_s=act_s)

        def run(a, dt):
            return fused_ssh_kernel.fused_ssh_heads(a, **args(dt, a.shape[0]))

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
        case = f"{label} {list(x.shape)}" + (" + up" if up is not None else "") + (
            " -> feature" if emit else "")
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
        a = args(torch.bfloat16)
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
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
    main = rows[2]  # scale 1 with the FPN: the largest of the three calls
    return entry("fused_ssh_heads_int8" if quant else "fused_ssh_heads", "fused_ssh.cu",
                 "avcer_tpu/ops/pallas/fused_ssh_kernel.py:" + ("51" if quant else "198"),
                 max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                 bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                 library_ms=main["library_ms"], shape=main["shape"], cases=rows)


def kernels_fused_chain_flat(card: str, detector) -> dict:
    """K5, which no model calls: detector layer1 at the main path's shape in
    bf16 (against its plain version, against fused_chain, and timed beside
    the unfused cuDNN section), and the three small f32 cases of the JAX
    package's test of its flat kernel, where it must equal fused_chain bit
    for bit."""
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
        log(f"kernel fused_chain_flat {blocks} {list(shape)} band {band} f32: max abs err "
            f"{err:.3g} to plain (atol 2e-4, rtol 1e-3); equal to fused_chain bit for bit: {same}")
        if not same:
            raise AssertionError(f"fused_chain_flat {blocks} {shape}: differs from fused_chain")

    layer, blocks, shape = detector.body.layer1, ("ds", "id", "id"), (DETECT_BATCH, 90, 160, 64)
    x = randn(shape, 302)
    folded = {dt: [t for bi in range(3) for t in layer[bi].folded(dt)]
              for dt in (torch.float32, torch.bfloat16)}
    err16 = check_fused(
        "fused_chain_flat", lambda a, dt: (flat(a, folded[dt], blocks),),
        lambda a, dt: (fused_resnet_kernel.fused_chain_flat_plain(a, folded[dt], blocks),),
        x, dict(atol=2e-4, rtol=1e-3), f"detector layer1 {blocks} {list(shape)}")
    x_cl = x.permute(0, 3, 1, 2)
    with torch.inference_mode():
        out = flat(x, folded[torch.bfloat16], blocks)
        same = torch.equal(out, chain(x, folded[torch.bfloat16], blocks))
        ms = median_ms(lambda: flat(x, folded[torch.bfloat16], blocks))
        chain_ms = median_ms(lambda: chain(x, folded[torch.bfloat16], blocks))
        plain = median_ms(lambda: fused_resnet_kernel.fused_chain_flat_plain(
            x, folded[torch.bfloat16], blocks), runs=10)
        lib_ms = median_ms(lambda: layer(x_cl))
    b_ms, b_by = bound_ms(*chain_work(x, folded[torch.bfloat16], blocks, out), "bf16")
    log(f"  detector layer1 {list(shape)} bf16: kernel {ms:.3f} ms (wrapper's pad, mask and "
        f"unflatten included; fused_chain {chain_ms:.3f} ms, equal to it: {same}), plain "
        f"{plain:.3f} ms, unfused cuDNN section {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) "
        f"(median of 50) on {card}")
    if not same:
        raise AssertionError("fused_chain_flat at detector layer1 bf16 differs from fused_chain")
    return entry("fused_chain_flat", "fused_resnet.cu",
                 "avcer_tpu/ops/pallas/fused_resnet_kernel.py:507", max_abs_err=err16, ms=ms,
                 plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                 shape=list(shape), fused_chain_ms=chain_ms, max_abs_err_f32=worst32,
                 on_main_path=False)


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
               kernels_fused_chain_flat(card, detector)])


def smoke_config(dtype: str, fused: bool = False, int8: bool = False) -> PipelineConfig:
    """``cli.run``'s configuration: ``--fused`` sets the seven fused switches,
    ``--serving_profile int8`` quantises all three stages and shares the audio
    extractor."""
    quant = "int8" if int8 else "none"
    return PipelineConfig(
        detector=DetectorConfig(batch_size=DETECT_BATCH, long_side=640, transfer_format="bgr",
                                dtype=dtype, quant=quant, fused_layer1=fused, fused_tails=fused,
                                fused_entries=fused, fused_ssh=fused, fused_fpn=fused),
        visual=VisualConfig(batch_size=CNN_BATCH, dtype=dtype, quant=quant, fused=fused,
                            fused_entries=fused),
        audio=AudioConfig(batch_size=AUDIO_BATCH, dtype=dtype, quant=quant, shared_extractor=int8),
        weights_dir=os.path.join(ROOT, "build", "smoke_no_weights"),
        save_plot=False,
    )


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-12))


def phase_reference(pipe, fused_pipe, frames: np.ndarray, wav: np.ndarray) -> None:
    """Each model on the card (bf16, CUDA kernels), unfused and fused, against
    the same seeded weights in f32 on the CPU (plain versions, unfused), one
    small input each. bf16 keeps 8 significant bits (2**-8 relative per
    rounding) and the errors of some 60 layers add up; a relative L2 error
    under 5 % passes, while a wrong kernel, layout or weight gives errors of
    order 100 %."""
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


def build(card: str, fused: bool, int8: bool = False):
    t0 = time.perf_counter()
    pipe = build_pipeline(smoke_config("bfloat16", fused, int8), device="cuda", seed=0)
    pipe.detect = ForceTopFace(pipe.detect, HEIGHT, WIDTH)
    torch.cuda.synchronize()
    log(f"build_pipeline (full width, seeded init, bf16, fused={fused}, int8={int8}"
        f"{', scales seeded on noise: one calibration forward a stage' if int8 else ''}): "
        f"{time.perf_counter() - t0:.2f} s")
    return pipe


def calibration_forwards(pipe) -> dict[str, int]:
    return {"detect": pipe.detect.inner.calibration_forwards,
            "visual": pipe.visual.calibration_forwards,
            "audio": pipe.audio.calibration_forwards}


def phase_main(card: str, pipe, fused: bool, frames: np.ndarray, wav: np.ndarray,
               int8: bool = False):
    """One warm-up run and TIMED_RUNS timed runs of one pipeline. Every count
    is set to 0 just before a timed run and read just after it. In int8 the
    warm-up run refines the noise-seeded scales on the clip's first frames,
    crops and windows (one calibration forward a stage, counted apart); the
    timed runs must then all run with the same frozen scales. Returns the last
    run's result and launch counts."""
    label = ("int8 " if int8 else "") + ("fused main path" if fused else "main path")
    cnn_calls = [0]
    hook = pipe.visual.static_model.register_forward_hook(
        lambda *_: cnn_calls.__setitem__(0, cnn_calls[0] + 1))
    t0 = time.perf_counter()
    pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
    torch.cuda.synchronize()
    log(f"{label} warm-up run: {time.perf_counter() - t0:.2f} s")
    if int8:
        calib = calibration_forwards(pipe)
        log(f"{label}: calibration forwards so far (seed at build + refinement in the warm-up "
            f"run), outside the timed runs: {calib}")
        if set(calib.values()) != {2}:
            raise AssertionError(f"{label}: expected 2 calibration forwards a stage, got {calib}")

    walls = []
    for run in range(1, TIMED_RUNS + 1):
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        cnn_calls[0] = 0
        pipe.detect.raw_kept = pipe.detect.frames = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = pipe.run(ArrayReader(frames, FPS, "smoke.avi"), "", wav=wav)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
        check_main_path(clip, frames.shape[0], launches, fused, cnn_calls[0], int8)
        if int8 and calibration_forwards(pipe) != calib:
            raise AssertionError(f"{label}: the scales moved in a timed run: "
                                 f"{calibration_forwards(pipe)}")
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in clip.timings.items())
        log(f"{label} timed run {run}: {stages} on {card}")
    hook.remove()
    log(f"detector kept {pipe.detect.raw_kept / max(pipe.detect.frames, 1):.1f} candidates "
        "per frame before the top one was forced to be the only face")
    wall = float(np.median(walls))
    log(f"{label}: {frames.shape[0]} frames ({CLIP_SECONDS} s of video), wall per run "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, median {wall:.3f} s = "
        f"{CLIP_SECONDS / wall:.3f} video-sec/sec on {card}; launches per run {launches}, "
        f"emotion CNN forward calls {cnn_calls[0]}")
    return clip, launches


def check_main_path(clip, n: int, launches: dict[str, int], fused: bool, cnn_calls: int,
                    int8: bool = False) -> None:
    """Shapes and values of one run's outputs, and each kernel's launches in
    that run: per detect batch one NMS call and, fused, 5 fused_chain calls
    (layer1, layer2, three chunks of layer3) and 3 fused_ssh_heads calls; per
    emotion-CNN forward, fused, 7 fused_chain calls (1 + 2 + 2 + 2 over the
    four layers); 12 attention calls per audio batch. With the int8 profile's
    shared extractor the full 4 s windows and the tail windows are batched
    apart, so the audio batches are counted for each group."""
    detect_batches = -(-n // DETECT_BATCH)
    windows = len(clip.audio_window_logits)
    if int8:
        samples = CLIP_SECONDS * 16000
        full = sum(start + 64000 <= samples for start in range(0, samples + 1, 8000))
        audio_batches = -(-full // AUDIO_BATCH) + -(-(windows - full) // AUDIO_BATCH)
    else:
        audio_batches = -(-windows // AUDIO_BATCH)
    want_chain = (5 * detect_batches + 7 * cnn_calls) if fused else 0
    want_ssh = 3 * detect_batches if fused else 0
    checks = {
        "stat_probs is [T, 7]": clip.stat_probs.shape == (n, 7),
        "stat_probs rows sum to 1": bool(np.allclose(clip.stat_probs.sum(1), 1.0, atol=1e-3)),
        "dyn_logits finite": bool(np.isfinite(clip.dyn_logits).all()),
        "audio logits finite": bool(np.isfinite(clip.audio_window_logits).all()),
        "audio logits are [17, 8]": clip.audio_window_logits.shape == (17, 8),
        "compound.av in 0..6": bool(clip.compound is not None
                                    and set(np.unique(clip.compound.av)) <= set(range(7))),
        "the emotion CNN ran": cnn_calls > 0,
        f"nms launches == {detect_batches} detect batches": launches["nms_mask"] == detect_batches,
        f"attention launches == 12 x {audio_batches} audio batches":
            launches["mha"] == 12 * audio_batches,
        f"fused_chain launches == {want_chain} (5 x {detect_batches} detect batches + "
        f"7 x {cnn_calls} CNN calls, fused only)": launches["fused_chain"] == want_chain,
        f"fused_ssh_heads launches == {want_ssh}": launches["fused_ssh_heads"] == want_ssh,
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


def main() -> int:
    card = phase_device()
    phase_build()
    pipe, fused_pipe = build(card, False), build(card, True)
    int8_pipe, int8_fused_pipe = build(card, False, True), build(card, True, True)
    kernels = phase_kernels(card, fused_pipe, int8_fused_pipe)
    int8_modules(card)
    frames, wav = make_clip()
    phase_reference(pipe, fused_pipe, frames, wav)
    phase_reference_int8(int8_pipe, int8_fused_pipe, frames, wav)
    clip, _ = phase_main(card, pipe, False, frames, wav)
    fused_clip, launches = phase_main(card, fused_pipe, True, frames, wav)
    int8_clip, _ = phase_main(card, int8_pipe, False, frames, wav, int8=True)
    int8_fused_clip, int8_launches = phase_main(card, int8_fused_pipe, True, frames, wav,
                                                int8=True)
    for k in kernels:
        if k["name"].endswith("_int8"):  # the same wrapper, counted in the int8 fused run
            k["launches"] = int8_launches[k["name"][:-len("_int8")]]
        else:
            k["launches"] = launches[k["name"]]
    agreement(fused_clip, clip, "fused vs unfused", 0.95)
    agreement(int8_fused_clip, int8_clip, "int8 fused vs int8 unfused", 0.80)
    # int8 against bf16 is another arithmetic (1e-2 in a probability): reported
    agreement(int8_clip, clip, "int8 vs bf16 (unfused)", 0.0)
    agreement(int8_fused_clip, fused_clip, "int8 fused vs bf16 fused", 0.0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
