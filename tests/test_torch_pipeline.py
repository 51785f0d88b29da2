"""The port's slice end to end against the JAX package on the CPU: the
detect stage on the same frames, Pipeline.run over one synthetic clip with
a stub detector on both sides, the output tree, and the import rule."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.core.config import (AudioConfig, DetectorConfig, PipelineConfig,
                                   VisualConfig)
from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
from avcer_tpu.models.emotion_resnet import EmotionResNet50 as JaxEmotionResNet50
from avcer_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from avcer_tpu.models.temporal_lstm import TemporalLSTM as JaxTemporalLSTM
from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V2Config
from avcer_tpu.pipeline import media as jax_media
from avcer_tpu.pipeline.detect import DetectStage as JaxDetectStage
from avcer_tpu.pipeline.runner import Pipeline as JaxPipeline

from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.ops.cuda import fused_resnet_kernel, nms_kernel
from avcer_tpu_torch.pipeline.builder import build_pipeline
from avcer_tpu_torch.pipeline.detect import DetectStage

from test_torch_models import randomize_stats

torch.set_num_threads(2)

TINY_W2V2 = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                 conv_dim=(16,) * 7)
H = W = 96
N_FRAMES, FPS = 30, 25


def slice_config(weights_dir: str) -> PipelineConfig:
    return PipelineConfig(
        detector=DetectorConfig(batch_size=8, long_side=64, transfer_format="bgr",
                                dtype="float32"),
        visual=VisualConfig(batch_size=16, dtype="float32"),
        audio=AudioConfig(batch_size=4, dtype="float32"),
        weights_dir=weights_dir,
        save_plot=False,
    )


class JaxStubDetect:
    """One centred face on every frame (tests/test_pipeline.py StubDetect)."""

    def dispatch(self, frames):
        b = frames.shape[0]
        packed = np.zeros((b, 8, 16), np.float32)
        packed[:, 0, 0:4] = [W * 0.25, H * 0.25, W * 0.75, H * 0.75]
        packed[:, 0, 4] = 0.95
        packed[:, 0, 5] = 1.0
        return packed, 1.0, jnp.asarray(frames)

    def unpack(self, packed_np, scale):
        return JaxDetectStage.unpack(packed_np, scale)


class PortStubDetect(JaxStubDetect):
    def dispatch(self, frames):
        packed, scale, _ = super().dispatch(frames)
        return torch.from_numpy(packed), scale, torch.from_numpy(frames)

    def unpack(self, packed_np, scale):
        return DetectStage.unpack(packed_np, scale)


@pytest.fixture(scope="module")
def clip_runs(tmp_path_factory):
    import cv2

    tmp = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(0)
    video = str(tmp / "clip.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (W, H))
    for _ in range(N_FRAMES):
        vw.write(rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8))
    vw.release()
    wav = (rng.normal(size=int(1.5 * 16000)) * 0.1).astype(np.float32)
    jax_media.write_wav(str(tmp / "clip.wav"), wav, 16000)

    cfg = slice_config(str(tmp / "no_weights"))
    # non-zero biases: with the init's zero conv biases, the mean-padded
    # tail of a short window normalises to rounding noise around 0 that the
    # first LayerNorm blows up to unit scale, and even the JAX package's own
    # host and device windowing paths then disagree by ~0.6 in the logits
    variables = {
        "emotion_resnet50": randomize_stats(init_variables(
            JaxEmotionResNet50(7), (jnp.zeros((1, 64, 64, 3)),), 1), 1),
        "temporal_lstm": init_variables(JaxTemporalLSTM(7), (jnp.zeros((1, 10, 512)),), 2),
        "expr_model": randomize_stats(init_variables(
            JaxExprModel("v3", 8, JaxW2V2Config(**TINY_W2V2)), (jnp.zeros((1, 17000)),), 3), 3),
    }
    jax_pipe = JaxPipeline(cfg, {}, variables["emotion_resnet50"], variables["temporal_lstm"],
                           variables["expr_model"], JaxW2V2Config(**TINY_W2V2))
    jax_pipe.detect = JaxStubDetect()
    want = jax_pipe.run(video, str(tmp / "out_jax"))

    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu",
                          jax_variables=variables)
    pipe.detect = PortStubDetect()
    got = pipe.run(video, str(tmp / "out_port"))

    # the same clip with the visual fused switches on (the stub detector stays)
    import dataclasses
    fused_cfg = dataclasses.replace(
        cfg, visual=dataclasses.replace(cfg.visual, fused=True, fused_entries=True))
    fused_pipe = build_pipeline(fused_cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu",
                                jax_variables=variables)
    fused_pipe.detect = PortStubDetect()
    calls = []
    inner = fused_resnet_kernel.fused_chain_plain
    fused_resnet_kernel.fused_chain_plain = lambda *a, **k: (calls.append(1), inner(*a, **k))[1]
    try:
        fused = fused_pipe.run(video, str(tmp / "out_port_fused"))
    finally:
        fused_resnet_kernel.fused_chain_plain = inner
    return want, got, tmp, fused, len(calls)


def test_slice_outputs_match_jax(clip_runs):
    want, got = clip_runs[:2]
    assert got.total_frames == want.total_frames == N_FRAMES
    # f32 on both sides; bounds of the emotion CNN / LSTM / ExprModel parity tests
    np.testing.assert_allclose(got.stat_probs, want.stat_probs, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got.dyn_logits, want.dyn_logits, atol=1e-3, rtol=1e-2)
    np.testing.assert_allclose(got.audio_window_logits, want.audio_window_logits,
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(got.audio_frame_ids, want.audio_frame_ids)
    np.testing.assert_array_equal(got.face_boxes, want.face_boxes)


def test_slice_compound_decisions_match_jax(clip_runs):
    """Decisions are equal on every frame except where the two best AV
    compound probabilities lie within 1e-4 of each other without being equal:
    f32 rounding may pick either there. Exact ties (Rule 1 zeroes many pairs)
    resolve to the first index on both sides."""
    want, got = clip_runs[:2]
    top2 = np.sort(want.compound.av_prob[:, :7], axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    decided = ~((gap > 0) & (gap <= 1e-4))
    np.testing.assert_allclose(got.compound.av_prob, want.compound.av_prob, atol=1e-4)
    for key in ("av", "vs", "vd", "a"):
        g, w = getattr(got.compound, key), getattr(want.compound, key)
        np.testing.assert_array_equal(g[decided], w[decided], err_msg=key)
    assert decided.mean() > 0.5


def test_fused_slice_matches_unfused_and_jax(clip_runs):
    """The clip with ``VisualConfig(fused=True, fused_entries=True)``: the
    emotion CNN went through ``fused_chain`` (7 calls a forward, on the CPU
    its plain version), and the outputs agree with the unfused port and with
    the JAX run within the bounds of the unfused slice test; decisions are
    equal except near-ties within 1e-4."""
    want, got, tmp, fused, chain_calls = clip_runs
    assert chain_calls > 0 and chain_calls % 7 == 0
    for ref in (got, want):
        np.testing.assert_allclose(fused.stat_probs, ref.stat_probs, atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(fused.dyn_logits, ref.dyn_logits, atol=1e-3, rtol=1e-2)
        np.testing.assert_allclose(fused.audio_window_logits, ref.audio_window_logits,
                                   atol=5e-4, rtol=1e-3)
        np.testing.assert_array_equal(fused.face_boxes, ref.face_boxes)
        top2 = np.sort(ref.compound.av_prob[:, :7], axis=1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        decided = ~((gap > 0) & (gap <= 1e-4))
        np.testing.assert_allclose(fused.compound.av_prob, ref.compound.av_prob, atol=1e-4)
        for key in ("av", "vs", "vd", "a"):
            np.testing.assert_array_equal(getattr(fused.compound, key)[decided],
                                          getattr(ref.compound, key)[decided], err_msg=key)
    files = sorted(str(p.relative_to(tmp / "out_port")) for p in (tmp / "out_port").rglob("*")
                   if p.is_file())
    assert files == sorted(str(p.relative_to(tmp / "out_port_fused"))
                           for p in (tmp / "out_port_fused").rglob("*") if p.is_file())


def test_slice_output_tree_matches_jax(clip_runs):
    tmp = clip_runs[2]
    jax_out, port_out = tmp / "out_jax", tmp / "out_port"
    files = sorted(str(p.relative_to(jax_out)) for p in jax_out.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(port_out)) for p in port_out.rglob("*")
                           if p.is_file())
    assert len(files) == 4
    for name in files:
        if name.endswith(".csv"):
            a, b = pd.read_csv(jax_out / name), pd.read_csv(port_out / name)
            assert list(a.columns) == list(b.columns)
            assert a.shape == b.shape
            if "frames" in a:
                assert list(a["frames"]) == list(b["frames"])
        else:
            a = (jax_out / name).read_text().splitlines()
            b = (port_out / name).read_text().splitlines()
            assert len(a) == len(b) and a[0] == b[0]
            assert [r.split(",")[0] for r in a] == [r.split(",")[0] for r in b]


def test_outputs_without_matplotlib(clip_runs, tmp_path, monkeypatch, caplog):
    """Where matplotlib is not installed the CSVs and the compound txt are
    still written; the plot is left out with a warning."""
    from types import SimpleNamespace

    import dataclasses
    from avcer_tpu_torch.pipeline.runner import Pipeline

    got = clip_runs[1]
    cfg = dataclasses.replace(slice_config(str(tmp_path / "no_weights")), save_plot=True)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with caplog.at_level("WARNING", logger="avcer_tpu_torch"):
        Pipeline._save_outputs_impl(SimpleNamespace(cfg=cfg), got, str(tmp_path / "out"), pd)
    files = sorted(str(p.relative_to(tmp_path / "out")) for p in (tmp_path / "out").rglob("*")
                   if p.is_file())
    assert len(files) == 4 and not any(f.endswith(".jpg") for f in files)
    assert "matplotlib is not installed" in caplog.text
    monkeypatch.undo()
    pytest.importorskip("matplotlib")
    Pipeline._save_outputs_impl(SimpleNamespace(cfg=cfg), got, str(tmp_path / "out"), pd)
    assert (tmp_path / "out" / "pedicted_CEs_Rule 1.jpg").exists()


def test_detect_stage_matches_jax():
    """The real detect stage on the same frames (already at the 64 bucket,
    so both sides see identical pixels), threshold low so that most of the
    64 candidates are valid."""
    variables = init_variables(JaxRetinaFace(backbone="resnet50"),
                               (jnp.zeros((1, 64, 64, 3)),), seed=5)
    cfg = DetectorConfig(long_side=64, batch_size=2, transfer_format="bgr",
                         threshold=0.3, dtype="float32")
    frames = np.random.default_rng(6).integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    want = JaxDetectStage(cfg, variables, dtype=jnp.float32)(frames)
    model = RetinaFace()
    model.load_state_dict(convert.retinaface(variables), strict=True)
    before = nms_kernel.nms_mask.launches
    stage = DetectStage(cfg, model.eval(), device="cpu")
    packed, scale, _ = stage.dispatch(frames)
    got = stage.unpack(packed.numpy(), scale)
    assert nms_kernel.nms_mask.launches == before  # the CPU path launches nothing
    assert want.keep.shape == got.keep.shape == (2, 64)
    assert 16 < want.scores.__gt__(0.3).sum(axis=1).min()
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-2, rtol=1e-3)
    np.testing.assert_allclose(got.landmarks, want.landmarks, atol=1e-2, rtol=1e-3)
    np.testing.assert_array_equal(got.keep, want.keep)


def test_import_guard_no_jax(tmp_path):
    """The port imports neither jax, flax nor anything of avcer_tpu: with all
    three blocked, the CLI module imports and a tiny CPU pipeline builds and
    runs one clip, fused switches on."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["avcer_tpu"] = None
import numpy as np, torch
torch.set_num_threads(2)
import avcer_tpu_torch.cli.run as cli
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.pipeline.builder import build_pipeline
from avcer_tpu_torch.pipeline.media import ArrayReader
import dataclasses
cfg = cli.config_from_args(cli.parse_args(["--weights_dir", {str(tmp_path)!r}, "--long_side", "64",
                                                "--fused"]))
# every CNN batch is filled up to its size: a small one for the CPU
cfg = dataclasses.replace(cfg, visual=dataclasses.replace(cfg.visual, batch_size=4))
pipe = build_pipeline(cfg, Wav2Vec2Config(**{TINY_W2V2!r}), device="cpu")
frames = np.random.default_rng(0).integers(0, 255, (3, 48, 64, 3), dtype=np.uint8)
clip = pipe.run(ArrayReader(frames, fps=25), "", wav=np.zeros(16000, np.float32))
assert clip.stat_probs.shape == (3, 7) and np.isfinite(clip.audio_window_logits).all()
assert not any(m in ("jax", "avcer_tpu") or m.startswith(("jax.", "flax", "avcer_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("IMPORT_GUARD_OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert "IMPORT_GUARD_OK" in proc.stdout, proc.stderr[-3000:]


@pytest.mark.parametrize("argv,names", [
    pytest.param(["--data_parallel", "2"], "mesh 2x1 exceeds 1 devices",
                 id="argv0-queue 1, parallelism"),
    pytest.param(["--serving_profile", "fastest"], "invalid choice", id="argv2-invalid choice"),
    pytest.param(["--calibrate"], "served", id='argv7-"Not ported"'),
    pytest.param(["--compile_cache_dir", "X"], "served", id='argv8-"Not ported"'),
])
def test_cli_rejects_unported_flags(argv, names, capsys):
    """What the CLI does not run is refused while the arguments are parsed,
    before any model is built. ``--data_parallel 2`` parses and builds a mesh
    of two devices: on the one CPU the build raises the JAX package's mesh
    error, before any model is built. ``--calibrate`` and
    ``--compile_cache_dir X``, which were refused by naming ROADMAP's "Not
    ported" list, are served: the first goes into the configuration, the
    second is the kernel build cache that ``main`` hands to ``_build``."""
    import avcer_tpu_torch.cli.run as cli

    if argv[0] == "--data_parallel":
        a = cli.parse_args(argv + ["--device", "cpu"])
        with pytest.raises(ValueError, match=names):
            build_pipeline(cli.config_from_args(a), device=a.device)
        return
    if names == "served":
        a = cli.parse_args(argv)
        assert cli.config_from_args(a).calibrate == (argv[0] == "--calibrate")
        assert a.compile_cache_dir == (argv[1] if argv[0] == "--compile_cache_dir" else None)
        assert capsys.readouterr().err == ""
        return
    with pytest.raises(SystemExit):
        cli.parse_args(argv)
    assert names in capsys.readouterr().err


def test_cli_refuses_only_the_unported_by_name(capsys):
    """Every flag of the JAX CLI parses together, ``--calibrate`` and
    ``--compile_cache_dir`` among them (no flag is refused any more); the
    configuration takes each."""
    import avcer_tpu_torch.cli.run as cli

    a = cli.parse_args(["--data_parallel", "2", "--calibrate", "--compile_cache_dir", "X",
                        "--heatmaps", "dynamic", "--save_face_crops", "--audio_head", "v1"])
    assert capsys.readouterr().err == ""
    cfg = cli.config_from_args(a)
    assert (cfg.mesh.data, cfg.calibrate, cfg.heatmaps, cfg.save_face_crops, cfg.audio.head) == \
        (2, True, "dynamic", True, "v1")
    assert a.compile_cache_dir == "X" and cfg.detector.transfer_format == "i420"


#: what each JAX command line changes in the default configuration; the
#: lines that restate the defaults change nothing
ACCEPTED = {
    ("--audio_head", "v3", "--audio_classes", "8"): {},
    ("--audio_classes", "8"): {},
    ("--profile_dir", ""): {},
    ("--heatmaps", "static"): {"heatmaps": "static"},
    ("--audio_classes", "7"): {"audio": {"head": "v2", "num_classes": 7}},
    ("--audio_head", "v1"): {"audio": {"head": "v1", "num_classes": 8}},
    ("--audio_head", "v2"): {"audio": {"head": "v2", "num_classes": 8}},
    ("--save_face_crops",): {"save_face_crops": True},
}


@pytest.mark.parametrize("argv", [list(a) for a in ACCEPTED])
def test_cli_accepts_jax_command_line(argv):
    """A JAX command line parses and maps to the configuration the JAX CLI
    builds from it (``avcer_tpu/core/config.py``): the defaults, or the
    default configuration with the flag's field changed."""
    import dataclasses

    import avcer_tpu_torch.cli.run as cli

    cfg = cli.config_from_args(cli.parse_args(argv))
    want = cli.config_from_args(cli.parse_args([]))
    for name, value in ACCEPTED[tuple(argv)].items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(want, name), **value)
        want = dataclasses.replace(want, **{name: value})
    assert cfg == want


def test_cli_serves_profiles_and_needs_card():
    """Every serving profile parses (tests/test_torch_presets.py holds each
    to the JAX CLI's mapping); the default device raises without a card
    instead of falling back."""
    import avcer_tpu_torch.cli.run as cli

    for profile, backbone in (("int8_s2", "resnet50"), ("fast", "mobilenet0.25")):
        cfg = cli.config_from_args(cli.parse_args(["--serving_profile", profile]))
        assert (cfg.detector.backbone, cfg.detector.quant) == (backbone, "int8")
    with pytest.raises(RuntimeError) if not torch.cuda.is_available() else pytest.raises(
            SystemExit):
        cli.main(["--path_video", "missing.avi"])


def test_cli_profiled_writes_chrome_trace(tmp_path):
    """``--profile_dir``'s helper: a tiny op under it leaves a Chrome trace
    that names the op."""
    import json

    import avcer_tpu_torch.cli.run as cli

    with cli.profiled(str(tmp_path / "trace"), device="cpu"):
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    trace = json.loads((tmp_path / "trace" / cli.TRACE_FILE).read_text())
    assert any("matmul" in e.get("name", "") for e in trace["traceEvents"])
