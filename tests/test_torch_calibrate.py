"""``--calibrate`` and ``--compile_cache_dir`` on the CPU.

The batch-size calibration (``pipeline.calibrate``): the chosen batches are
applied and cached, a cached record is adopted without measuring (disjoint
candidates prove it), the record's validation against the JAX package's,
the cache key, and a CNN candidate that does not divide over the mesh's data
axis skipped. The kernel build cache (``_build``) without nvcc (the toolkit
string and the compiler are stand-ins): the directory chosen by the flag, by
``AVCER_COMPILE_CACHE`` and by default, the disabling values, and the hash
moving with the toolkit."""

import dataclasses
import json
import logging
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from avcer_tpu.pipeline.calibrate import valid_record as jax_valid_record

import avcer_tpu_torch.cli.run as cli
from avcer_tpu_torch import _build
from avcer_tpu_torch.core.config import (AudioConfig, DetectorConfig, MeshConfig,
                                         PipelineConfig, VisualConfig)
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.pipeline import calibrate
from avcer_tpu_torch.pipeline.builder import build_pipeline

from test_torch_models import TINY_W2V2

torch.set_num_threads(2)


def tiny_config(tmp_path, **kw) -> PipelineConfig:
    return PipelineConfig(detector=DetectorConfig(batch_size=8, long_side=64, dtype="float32"),
                          visual=VisualConfig(batch_size=16, dtype="float32"),
                          audio=AudioConfig(batch_size=4, dtype="float32"),
                          weights_dir=str(tmp_path / "nonexistent_weights"), **kw)


def test_calibrate_batch_sizes(tmp_path):
    """One-shot calibration measures the candidates, applies the optimum to
    the live pipeline, and round-trips through its cache (tests/test_pipeline.py
    test_calibrate_batch_sizes): a second pipeline is served from the cache
    with disjoint candidates, so nothing is measured again."""
    cfg = tiny_config(tmp_path)
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu")
    cache = str(tmp_path / "calib.json")
    rec = calibrate.calibrate(pipe, cache_path=cache, cnn_batches=(4, 8), audio_batches=(2, 4))
    assert rec["visual_batch"] in (4, 8)
    assert rec["audio_batch"] in (2, 4)
    assert set(rec["cnn_ms_per_frame"]) == {"4", "8"}
    assert set(rec["audio_ms_per_window"]) == {"2", "4"}
    assert pipe.visual.batch_size == rec["visual_batch"]
    assert pipe.audio.cfg.batch_size == rec["audio_batch"]
    assert valid_record_both(rec)
    assert json.loads(Path(cache).read_text()) == {calibrate._cache_key(pipe): rec}
    pipe2 = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu")
    rec2 = calibrate.calibrate(pipe2, cache_path=cache, cnn_batches=(999,), audio_batches=(999,))
    assert rec2 == rec
    assert pipe2.visual.batch_size == rec["visual_batch"]
    assert pipe2.audio.cfg.batch_size == rec["audio_batch"]


def valid_record_both(rec) -> bool:
    got = calibrate.valid_record(rec)
    assert got == jax_valid_record(rec)
    return got


GOOD = {"visual_batch": 8, "audio_batch": 4, "cnn_ms_per_frame": {"4": 1.0, "8": 0.7},
        "audio_ms_per_window": {"2": 3.0, "4": 2.5}}


@pytest.mark.parametrize("rec,valid", [
    (GOOD, True),
    (None, False),
    ("256", False),
    ({}, False),
    ({**GOOD, "visual_batch": "8"}, False),  # str, not int
    ({**GOOD, "visual_batch": -8}, False),
    ({**GOOD, "audio_batch": 16}, False),  # unmeasured
    ({k: v for k, v in GOOD.items() if k != "cnn_ms_per_frame"}, False),
    ({**GOOD, "audio_batch": 0, "audio_ms_per_window": {"0": 1.0}}, False),
], ids=["good", "none", "str", "empty", "str_batch", "negative", "unmeasured", "no_cnn_ms",
        "zero"])
def test_valid_record_equals_jax(rec, valid):
    """Corrupt or hand-edited cache entries are measured again, as the JAX
    package's ``valid_record`` decides (tests/test_pipeline.py
    test_calibration_record_validation)."""
    assert valid_record_both(rec) is valid


def test_cache_key_names_the_device_and_the_quantisation(tmp_path):
    """The key says ``cpu`` on the CPU (the card's name on a card), and an
    exact record never serves int8: every stage's quantisation, the shared
    extractor and the data axis are part of it."""
    base = cli.config_from_args(cli.parse_args([]))
    key = calibrate._cache_key(SimpleNamespace(cfg=base, device=torch.device("cpu")))
    assert key.split("|")[0] == "cpu"
    keys = {key}
    for profile in ("int8", "fast"):
        cfg = cli.config_from_args(cli.parse_args(["--serving_profile", profile]))
        keys.add(calibrate._cache_key(SimpleNamespace(cfg=cfg, device=torch.device("cpu"))))
    for change in (dict(visual=dataclasses.replace(base.visual, quant="int8")),
                   dict(audio=dataclasses.replace(base.audio, quant="int8")),
                   dict(detector=dataclasses.replace(base.detector, quant="int8")),
                   dict(mesh=MeshConfig(data=2))):
        cfg = dataclasses.replace(base, **change)
        keys.add(calibrate._cache_key(SimpleNamespace(cfg=cfg, device=torch.device("cpu"))))
    assert len(keys) == 7
    assert calibrate.DEFAULT_CACHE.endswith(".json")
    assert "avcer_calibration_torch_" in calibrate.DEFAULT_CACHE


def test_calibrate_skips_a_cnn_batch_the_mesh_does_not_divide(tmp_path, caplog):
    """Over a data axis of 2 (the CPU named twice), a CNN candidate of 3 does
    not divide: it is skipped, with a log line; 2 is measured and chosen. No
    cache is written (``cache_path=None``)."""
    cfg = tiny_config(tmp_path, mesh=MeshConfig(data=2))
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu",
                          mesh_devices=["cpu", "cpu"])
    with caplog.at_level(logging.INFO, logger="avcer_tpu_torch"):
        rec = calibrate.calibrate(pipe, cache_path=None, cnn_batches=(3, 2), audio_batches=(1,))
    assert rec["visual_batch"] == 2 and set(rec["cnn_ms_per_frame"]) == {"2"}
    assert "crop-CNN b3 skipped" in caplog.text
    assert pipe.visual.batch_size == 2 and pipe.audio.cfg.batch_size == 1
    with pytest.raises(ValueError, match="no CNN candidate"):
        calibrate.calibrate(pipe, cache_path=None, cnn_batches=(3,), audio_batches=(1,))


# ---------------------------------------------------------------- the build cache

@pytest.fixture
def fake_toolkit(monkeypatch):
    """``_build`` with no library loaded, no directory chosen, and stand-ins
    for ``nvcc --version`` and for the compiler (which writes the library's
    file and counts the builds)."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_build_dir", None)
    monkeypatch.setattr(_build, "compiles", 0)
    monkeypatch.delenv(_build.CACHE_ENV, raising=False)
    version = {"text": "nvcc: NVIDIA (R) Cuda compiler driver\nCuda compilation tools, "
                       "release 12.4, V12.4.131"}
    monkeypatch.setattr(_build, "toolkit", lambda: version["text"])
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")

    def fake_run(cmd, capture_output=True, text=True):
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"library")
        return SimpleNamespace(returncode=0, stdout="", stderr="ptxas info: 0 spills")

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    yield version
    monkeypatch.setattr(_build, "_build_dir", None)


def test_build_dir_from_flag_environment_and_default(fake_toolkit, tmp_path, monkeypatch):
    """In order: ``set_cache_dir`` (what ``cli.run --compile_cache_dir`` and
    ``cli.train_audio --compile_cache_dir`` call before any kernel is
    loaded), ``AVCER_COMPILE_CACHE``, then ``build/avcer_tpu_torch/`` in the
    checkout. A library built into a directory is loaded from it by the next
    process without a build."""
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR
    assert _build.DEFAULT_BUILD_DIR.parts[-2:] == ("build", "avcer_tpu_torch")
    monkeypatch.setattr(_build, "_build_dir", None)
    monkeypatch.setenv(_build.CACHE_ENV, str(tmp_path / "env"))
    assert _build.build_dir() == tmp_path / "env"
    assert _build.set_cache_dir(str(tmp_path / "flag")) == tmp_path / "flag"  # over the env
    assert _build.set_cache_dir(None) == tmp_path / "env"
    _build.set_cache_dir(str(tmp_path / "flag"))
    built = _build._compile("image")
    assert built.parent == tmp_path / "flag" and built.exists() and _build.compiles == 1
    assert built.with_suffix(".log").read_text().endswith("0 spills")
    assert _build._compile("image") == built and _build.compiles == 1  # warm: no build
    a = cli.parse_args(["--compile_cache_dir", str(tmp_path / "flag")])
    assert a.compile_cache_dir == str(tmp_path / "flag")
    assert cli.parse_args([]).compile_cache_dir is None  # the env or the default


@pytest.mark.parametrize("token", ["", "0", "off", "none", "disabled", " OFF "])
@pytest.mark.parametrize("source", ["flag", "env"])
def test_disabling_values_build_into_a_fresh_directory(fake_toolkit, token, source,
                                                       monkeypatch):
    """The JAX package's values that turn its cache off give a fresh
    temporary directory here, from the flag as from the environment: every
    kernel builds anew, as JAX compiles anew."""
    if source == "env":
        monkeypatch.setenv(_build.CACHE_ENV, token)
        first = _build.build_dir()
        monkeypatch.setattr(_build, "_build_dir", None)
        second = _build.build_dir()
    else:
        first, second = _build.set_cache_dir(token), _build.set_cache_dir(token)
    assert first != second and first.is_dir() and second.is_dir()
    assert not list(first.iterdir())
    assert first.name.startswith("avcer_tpu_torch_build_")
    assert _build.DEFAULT_BUILD_DIR not in (first, second)
    _build._compile("nms")
    assert _build.compiles == 1


def test_library_hash_moves_with_the_toolkit(fake_toolkit, tmp_path):
    """Another ``nvcc --version`` names another library, so a directory
    shared between machines never loads what another toolkit built; the
    same toolkit names the same one. The flags are part of it too
    (``--fmad=false`` for the bit-exact kernels)."""
    _build.set_cache_dir(str(tmp_path))
    paths = {name: _build.library_path(name) for name in _build.KERNELS}
    assert len(set(paths.values())) == len(_build.KERNELS)
    assert _build.library_path("image") == paths["image"]
    fake_toolkit["text"] = fake_toolkit["text"].replace("12.4", "12.6")
    for name in _build.KERNELS:
        moved = _build.library_path(name)
        assert moved != paths[name] and moved.parent == tmp_path
        assert moved.name.startswith(f"{name}-")
    assert _build._EXTRA_FLAGS["image"] == _build._EXTRA_FLAGS["nms"] == ("--fmad=false",)
