"""The model families as data: each configuration's ``models`` block names
the family files and their shapes, and moving the families out of code moved
nothing the benchmark reads.

The digests below were taken from the code that held the families' sizes
and forwards in Python, with the same inputs, on the CPU in one thread: the
weights ``weights.make`` draws and calibrates, the reference's detector and
audio outputs on a small clip, and the work counts behind ``mfu``. The
digests of float results hold for one CPU's kernels; where the weights'
digest holds and another fails on another CPU, the kernels' rounding differs
there.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from perfbench import program, weights, work
from perfbench.reference import models as M
from perfbench.reference import pipeline as P
from perfbench.reference.clip import Reference, exact_float32
from perfbench.tests import tiny
from perfbench.traffic import Traffic

CONFIGS = ("parity_fused", "max_fused")
SEEDS = (2 ** 31 + 101, 7)

WEIGHTS = {
    ("parity_fused", SEEDS[0]): "3cf2049085b70285db2bd100d5c0eb14bad731cf4d2ec13d13a400b95b8cef64",
    ("parity_fused", SEEDS[1]): "9b8a6b52f151a11adbbe5bf3bcb87e838fb6d247a8f787697a2ccec755873658",
    ("max_fused", SEEDS[0]): "233be527a4e196414dc6e655afc216eaab1c1c98fc17135931ea320fa1b9aab4",
    ("max_fused", SEEDS[1]): "15828bb017e71b6180d33554b5d8819b5a1651a7a91e7c6ce2a9aadcd466e88d",
}
REFERENCE = {
    "parity_fused": ("614314db7e1e9e0215fdd101ba3d2630afa4ebf9c9af9c5d472a97953df23c9e",
                     "31a890413e8a6564a0121782ce6eaf58390fd8227648e59e171c1243eed42015"),
    "max_fused": ("5c9415975ae0ed99a41369b38302467001887baad1ae5ef7069d81105a9dbb30",
                  "2d9deaddf9d2fa8476500016d0b43156fa173d6bcebfc00e91f177c75c1dee5f"),
}
#: {type: operations} of a clip (height, width, frames, samples) at the
#: published shapes
WORK = {
    ("parity_fused", (360, 640), 250, 160000): {"bf16": 16491385285632.0},
    ("parity_fused", (64, 96), 75, 48000): {"bf16": 5713209429504.0},
    ("max_fused", (360, 640), 250, 160000): {"bf16": 252805257728.0, "int8": 1932845588480.0},
    ("max_fused", (64, 96), 75, 48000): {"bf16": 84732904960.0, "int8": 695071522816.0},
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def config(name: str) -> dict:
    with open(os.path.join(tiny.ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)


def weights_digest(w: dict) -> str:
    """Every tensor's name, shape, dtype and bytes in draw order (the roles'
    names left out)."""
    h = hashlib.sha256()
    for sd in w.values():
        for k, v in sd.items():
            h.update(k.encode())
            h.update(str(tuple(v.shape)).encode())
            h.update(str(v.dtype).encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def arrays_digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_and_reference_are_unmoved(name, one_thread):
    """``weights.make`` at two seeds and the reference's detector and audio
    outputs (both audio paths: ``max_fused`` shares the extractor) at the
    small cell's sizes, bit for bit."""
    serving = dict(config(name)["serving"], long_side=96)
    families = tiny.families(config(name))
    for seed in SEEDS:
        w = weights.make(seed, serving, Traffic(tiny.MIX, seed), "cpu", families)
        assert weights_digest(w) == WEIGHTS[name, seed], seed
        if seed != SEEDS[0]:
            continue
        clip = Traffic(tiny.MIX, seed).clip(0)
        ref = Reference(w, serving, families)
        with torch.no_grad(), exact_float32():
            wire, _ = P.wire_frames(torch.from_numpy(clip.frames[:3]), 96)
            det = ref.detector(wire)
            audio = ref.audio(clip.wav, clip.fps, clip.frames.shape[0])
        assert (arrays_digest(det), arrays_digest(audio)) == REFERENCE[name]


@pytest.mark.parametrize("name,hw,frames,samples", list(WORK))
def test_work_counts_are_unmoved(name, hw, frames, samples):
    families = M.load_families(config(name)["models"], tiny.ROOT)
    ops = work.clip_work(config(name)["serving"], hw, frames, 25.0, samples, families)
    assert ops == WORK[name, hw, frames, samples]


class _Placed(Exception):
    """Raised where the builder first places a model: every model is built."""


def program_state_shapes(config: dict, tmp: str) -> dict:
    """{class name: {state dict key: shape}} of every model the program's
    argv builds, on ``meta`` and uninitialised (no forward pass)."""
    from avcer_tpu_torch.pipeline import builder

    cfg = program.pipeline_config(config, program.no_weights_dir(tmp))
    seen = {}

    def record(model, generator):
        seen[type(model).__name__] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        return model

    def placed(*args, **kwargs):
        raise _Placed

    saved = builder.seeded_init_, builder.cast_compute
    builder.seeded_init_, builder.cast_compute = record, placed
    try:
        with torch.device("meta"), pytest.raises(_Placed):
            builder.build_pipeline(cfg, device="cpu")
    finally:
        builder.seeded_init_, builder.cast_compute = saved
    return seen


@pytest.mark.parametrize("name", CONFIGS)
def test_family_specs_are_the_programs_state_dicts(name, tmp_path):
    """The names and shapes each family of the configuration draws are the
    state dict of the model of the class it names, as the configuration's
    argv builds it at full width: a timed run's strict load holds the
    program to the ``models`` block."""
    c = config(name)
    families = M.load_families(c["models"], tiny.ROOT)
    built = program_state_shapes(c, str(tmp_path))
    assert sorted(built) == sorted(f.program_class for f in families.values())
    for fam in families.values():
        spec = {n: s for n, s, _ in fam.spec()}
        assert spec == built[fam.program_class], fam.role

