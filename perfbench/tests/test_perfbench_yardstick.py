"""The yardstick's parts on their own: the traffic, the scripted face, the
work functions, the busy-interval arithmetic, the wire, and the imports."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import work
from perfbench.face import ScriptedFace
from perfbench.reference import pipeline as P
from perfbench.tests.tiny import MIX, ROOT
from perfbench.traffic import Traffic


def test_traffic_same_seed_same_clips_other_seed_other():
    a, b, c = Traffic(MIX, 2 ** 31 + 11), Traffic(MIX, 2 ** 31 + 11), Traffic(MIX, 2 ** 31 + 12)
    for k in range(4):
        ca, cb, cc = a.clip(k), b.clip(k), c.clip(k)
        assert ca.seconds == cb.seconds and ca.offset == cb.offset
        assert np.array_equal(ca.frames, cb.frames) and np.array_equal(ca.wav, cb.wav)
        assert np.array_equal(ca.boxes, cb.boxes)
    assert not np.array_equal(a.frames, c.frames) and not np.array_equal(a.wav, c.wav)
    # every seed serves the same lengths, in another order
    assert sorted(a.cycle) == sorted(c.cycle) == sorted(MIX["clip_seconds"])


def test_the_square_is_where_the_boxes_say_and_stays_whole():
    t = Traffic(dict(MIX, clip_seconds=[8]), 5)
    s = MIX["face_px"]
    assert (t.boxes[:, 0] >= 0).all() and (t.boxes[:, 2] <= MIX["width"]).all()
    assert (t.boxes[:, 1] >= 0).all() and (t.boxes[:, 3] <= MIX["height"]).all()
    for i in range(0, len(t.boxes), 7):
        x0, y0, x1, y1 = t.boxes[i].astype(int)
        assert x1 - x0 == s and y1 - y0 == s
        assert t.frames[i, y0:y1, x0:x1].min() >= 100  # the square's texture
    # it moves without jumps: neighbouring frames overlap
    assert np.abs(np.diff(t.boxes, axis=0)).max() <= max(MIX["face_speed_px"]) + 1


class _Stage:
    class cfg:
        batch_size = 8
        stride = 2

    @staticmethod
    def unpack(packed, scale):
        from avcer_tpu_torch.pipeline.detect import DetectStage

        return DetectStage.unpack(packed, scale)


def test_scripted_face_gives_the_squares_box():
    clip = Traffic(MIX, 9).clip(0)
    face = ScriptedFace(_Stage())
    face.start_clip(clip.boxes)
    packed = np.random.default_rng(0).normal(size=(4, 64, 16)).astype(np.float32)
    for batch in range(-(-len(clip.boxes) // 8)):
        det = face.unpack(packed, 0.5)
        rows = np.minimum(batch * 8 + 2 * np.arange(4), len(clip.boxes) - 1)
        assert np.array_equal(det.boxes[:, 0], clip.boxes[rows])
        assert det.keep[:, 0].all() and not det.keep[:, 1:].any()
    assert len(face.packed) == -(-len(clip.boxes) // 8)  # the detector's own outputs kept


def test_chain_work_by_hand():
    """Detector layer1 (ds, id, id) at [2, 8, 10, 64] in bf16."""
    px = 2 * 8 * 10
    ds = px * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256)
    ident = px * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    weights = (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256) + 2 * (256 * 64 + 9 * 64 * 64
                                                                    + 64 * 256)
    scales = (64 + 64 + 256 + 256) + 2 * (64 + 64 + 256)
    nbytes, ops = work.chain_work((2, 8, 10, 64), ("ds", "id", "id"), 2, False, px * 256 * 2)
    assert ops == {"bf16": 2.0 * (ds + 2 * ident)}
    assert nbytes == px * 64 * 2 + px * 256 * 2 + weights * 2 + scales * 2 * 2
    # a stride-2 entry: conv1 at the input's resolution, the rest at half
    _, ops = work.chain_work((1, 4, 6, 256), ("s2ds",), 2, True, 0)
    assert ops == {"int8": 2.0 * (24 * 256 * 128 + 6 * (9 * 128 * 128 + 128 * 512 + 256 * 512))}


def test_ssh_work_by_hand():
    """r50 scale 2 with the FPN: lateral 1x1 from 1024, merge 3x3, the five
    SSH convs at 256, the heads (2 anchors x 16)."""
    px = 2 * 3 * 5
    conv = 1024 * 256 + 9 * 256 * 256 + 9 * (256 * 128 + 256 * 64 + 3 * 64 * 64)
    head = 256 * 32
    nbytes, ops = work.ssh_work((2, 3, 5, 1024), 0.0, True, True, 100, False, 2, 1000)
    assert ops == {"bf16": 2.0 * px * (conv + head)}
    assert nbytes == px * 1024 * 2 + 100 + 1000 + conv * 2 + head * 2
    _, ops = work.ssh_work((1, 2, 2, 64), 0.1, False, False, 0, True, 2, 0)
    assert ops["int8"] == 2.0 * 4 * 9 * (64 * 32 + 64 * 16 + 3 * 16 * 16)
    assert ops["bf16"] == 2.0 * 4 * 64 * 32


def test_busy_union_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (6.0, 6.5)]
    assert work.busy_union(iv) == pytest.approx(3.5)
    assert work.idle_gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0), (6.5, 7.0)]
    assert work.busy_union([]) == 0.0


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert work.bound_s(3.35e12, {"bf16": 1.0}) == pytest.approx(1.0)
    assert work.bound_s(1.0, {"bf16": 989e12, "int8": 1979e12}) == pytest.approx(2.0)


def test_wire_equals_the_cli_wire():
    """The reference's I420 round trip equals cv2's conversion and the port's
    plain rebuild bit for bit; its letterbox is within 1 of cv2's."""
    import cv2

    from avcer_tpu_torch.ops.image import bgr_batch_to_i420, i420_to_bgr_plain

    f = np.random.default_rng(1).integers(0, 256, (2, 36, 64, 3), dtype=np.uint8)
    want = i420_to_bgr_plain(torch.from_numpy(bgr_batch_to_i420(f)), 36, 64).numpy()
    assert np.array_equal(P.i420_roundtrip(torch.from_numpy(f)).numpy(), want)
    g = np.random.default_rng(2).integers(0, 256, (1, 90, 160, 3), dtype=np.uint8)
    cv = cv2.resize(g[0], (112, 64), interpolation=cv2.INTER_LINEAR)
    got = P.resize_bilinear(torch.from_numpy(g), 64, 112).numpy()[0]
    assert np.abs(cv.astype(int) - got).max() <= 1


def test_model_work_counts():
    """The reference's own count of one frame, crop and window at the
    published widths."""
    serving = dict(backbone="resnet50", long_side=640, det_stride=1, cnn_stride=1,
                   shared_extractor=False, quant=False)
    from perfbench.reference import models as M

    ops = work.clip_work(serving, (360, 640), 25, 25, 16000, M.W2V2)
    unit = work.unit_work(tuple(sorted(serving.items())),
                          tuple(sorted(M.W2V2.items())), (360, 640))
    windows = len(P.audio_windows(16000))
    want = (25 * unit["frame"]["bf16"] + 25 * unit["crop"]["bf16"]
            + 5 * unit["lstm"]["bf16"] + windows * unit["window"]["bf16"])
    assert ops == {"bf16": pytest.approx(want)}
    assert 45e9 < unit["frame"]["bf16"] < 55e9 and 7e9 < unit["crop"]["bf16"] < 8.5e9


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "avcer_tpu")


def _loaded(code: str) -> set:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_the_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    """Every module the harness, its readers and the program's entry load:
    none is JAX, its libraries or the JAX package (top-level names compared
    whole, so ``avcer_tpu_torch`` passes); the reference loads nothing of the
    port either."""
    run = _loaded(
        "import glob, perfbench.harness as h, perfbench.program, perfbench.spans, "
        "perfbench.check, perfbench.weights, perfbench.control\n"
        "import avcer_tpu_torch.pipeline.builder, avcer_tpu_torch.cli.run, "
        "avcer_tpu_torch.pipeline.media, avcer_tpu_torch.models.retinaface\n"
        "[h.metric_reader(h.ROOT, p.split('/')[-1][:-3]) for p in "
        "glob.glob('perfbench/metrics/*.py')]")
    assert "avcer_tpu_torch" in run and not run & set(FORBIDDEN)
    ref = _loaded("import perfbench.reference.clip, perfbench.reference.models, "
                  "perfbench.reference.pipeline")
    assert not ref & (set(FORBIDDEN) | {"avcer_tpu_torch"})


def test_run_without_a_card_fails_and_prints_no_result(tmp_path):
    """No CUDA device: a non-zero exit and no result line, here and in a
    directory that holds only BENCHMARK.json and perfbench/."""
    import shutil

    for root in (ROOT, str(tmp_path)):
        if root != ROOT:
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
            shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(root, "perfbench"),
                            ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                              "parity_fused.long_clips", "--seed", str(2 ** 31 + 3), "--seconds",
                              "1", "--trace", "0"], cwd=root, capture_output=True, text=True,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
        assert out.returncode != 0
        assert "metrics" not in out.stdout and "memory_peak_bytes" not in out.stdout
