"""The int8 serving path of avcer_tpu_torch, stage by stage and as a whole,
against the JAX package on the CPU: calibration (running max, merge,
structure mismatch, fused models), the three stages' seeding and refinement,
the shared audio extractor, ``Pipeline.run`` with ``quant="int8"`` on both
sides, and the mapping of the int8 profile by the CLI and ``build_pipeline``.

Inputs and weights come from numpy generators and go to both sides. See
tests/test_torch_int8.py for what a flipped quantised value does to a
tolerance."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.core.config import AudioConfig, DetectorConfig, PipelineConfig
from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
from avcer_tpu.models.emotion_resnet import EmotionResNet50 as JaxEmotionResNet50
from avcer_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from avcer_tpu.models.temporal_lstm import TemporalLSTM as JaxTemporalLSTM
from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V2Config
from avcer_tpu.pipeline import media as jax_media
from avcer_tpu.pipeline.audio_stage import AudioStage as JaxAudioStage
from avcer_tpu.pipeline.detect import DetectStage as JaxDetectStage
from avcer_tpu.pipeline.runner import Pipeline as JaxPipeline

import avcer_tpu_torch.cli.run as cli
from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk
from avcer_tpu_torch.pipeline.audio_stage import AudioStage
from avcer_tpu_torch.pipeline.builder import build_pipeline
from avcer_tpu_torch.pipeline.detect import DetectStage
from avcer_tpu_torch.pipeline.runner import check_supported
from avcer_tpu_torch.pipeline.visual import VisualStage

from test_torch_int8 import numpy_tree
from test_torch_models import TINY_W2V2, port, randomize_stats
from test_torch_pipeline import (FPS, H, N_FRAMES, W, JaxStubDetect, PortStubDetect,
                                 slice_config)

torch.set_num_threads(2)


# -------------------------------------------------------------- calibration

def test_calibration_running_max_merge_and_mismatch():
    """Scales only grow; a merge is the elementwise max; a tree of another
    structure raises, on merge and on load; the exact model's state dict
    loads into the int8 model and back."""
    gen = torch.Generator().manual_seed(0)
    model = layers.seeded_init_(EmotionResNet50(7, quant=True), gen).eval().requires_grad_(False)
    rng = np.random.default_rng(50)
    quiet = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    assert layers.act_scales(model) == {}  # uncalibrated: dynamic scales
    with layers.calibrating(model):
        model(quiet)
    first = layers.act_scales(model)
    assert len(first) == 53 and all(float(v) > 0 for v in first.values())
    with layers.calibrating(model):
        model(quiet * 0.5)  # a quieter input moves nothing
    assert all(torch.equal(v, first[k]) for k, v in layers.act_scales(model).items())
    with layers.calibrating(model):
        model(quiet * 3)
    grown = layers.act_scales(model)
    assert all(float(grown[k]) >= float(first[k]) for k in first)
    assert float(grown["conv_layer_s2_same"]) == pytest.approx(3 * float(first["conv_layer_s2_same"]))
    model(quiet * 100)  # serving never updates the scales
    assert all(torch.equal(v, grown[k]) for k, v in layers.act_scales(model).items())

    mixed = {k: (v * 2 if i % 2 else v * 0.5) for i, (k, v) in enumerate(first.items())}
    merged = layers.merge_act_scales_trees(first, mixed)
    assert all(float(merged[k]) == max(float(first[k]), float(mixed[k])) for k in first)
    short = dict(list(first.items())[:-1])
    with pytest.raises(ValueError, match="differ in structure"):
        layers.merge_act_scales_trees(first, short)
    with pytest.raises(ValueError, match="do not fit"):
        layers.load_act_scales(model, short)

    exact = EmotionResNet50(7)
    exact.load_state_dict(model.state_dict(), strict=True)
    model.load_state_dict(exact.state_dict(), strict=True)
    assert not any("amax" in k for k in model.state_dict())


def test_fused_models_never_update_scales(monkeypatch):
    """A fused int8 model serves through the fused kernel and leaves the
    scales alone; its calibration forward runs the unfused modules over the
    same weights; new scales drop the folds that held the old ones; and an
    uncalibrated model refuses the fused int8 path."""
    calls = []
    inner = frk.fused_chain_plain
    monkeypatch.setattr(frk, "fused_chain_plain",
                        lambda *a, **k: (calls.append(k.get("act_s")), inner(*a, **k))[1])
    gen = torch.Generator().manual_seed(1)
    model = layers.seeded_init_(EmotionResNet50(7, quant=True, fused=True, fused_entries=True),
                                gen).eval().requires_grad_(False)
    rng = np.random.default_rng(51)
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    with pytest.raises(RuntimeError, match="calibrated activation scales"):
        model(x)
    calls.clear()
    with layers.calibrating(model):
        model(x)
    assert calls == []  # the unfused modules ran
    scales = layers.act_scales(model)
    first = model(x)[0]
    assert len(calls) == 7 and all(a is not None for a in calls)  # the int8 mode
    assert all(torch.equal(v, scales[k]) for k, v in layers.act_scales(model).items())
    with layers.calibrating(model):
        model(x * 4)
    assert model._folds == {}
    assert not torch.equal(model(x)[0], first)  # served with the grown scales


def test_stages_calibrate_like_jax():
    """The three stages seed their scales at build on the JAX package's noise
    inputs; the detect stage refines them on the first real batch's first two
    frames and then serves with them frozen, watching every RECALIB_EVERY
    batches."""
    jm = JaxRetinaFace(backbone="resnet50", dtype=jnp.float32, quant=True)
    variables = numpy_tree(init_variables(jm, (jnp.zeros((1, 64, 64, 3)),), seed=5))
    cfg = DetectorConfig(long_side=64, batch_size=2, transfer_format="bgr", threshold=0.3,
                         dtype="float32", quant="int8")
    jax_stage = JaxDetectStage(cfg, variables, dtype=jnp.float32)
    model = port(RetinaFace(quant=True), convert.retinaface(variables)).requires_grad_(False)
    stage = DetectStage(cfg, model, device="cpu")
    assert stage.calibration_forwards == 1 and not stage._real_calibrated

    def jax_scales():
        return convert.act_scales("retinaface", {**variables, "act_scales": numpy_tree(
            jax_stage.variables["act_scales"])})

    def assert_scales_equal():
        want, got = jax_scales(), layers.act_scales(model)
        assert set(want) == set(got)
        # a calibration forward quantises each conv's input with the running
        # scale, so a value flipped upstream (one f32 ulp apart in a quotient)
        # moves a later conv's input max by a quantisation step: 1 % here
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-2, err_msg=k)
        np.testing.assert_allclose(float(got["body.layer1.0.conv1"]),
                                   float(want["body.layer1.0.conv1"]), rtol=1e-6)

    assert_scales_equal()  # seeded on default_rng(0).integers(0, 255, (2, 160, 160, 3))
    frames = np.random.default_rng(6).integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    want = jax_stage(frames)
    packed, scale, _ = stage.dispatch(frames)
    got = stage.unpack(packed.numpy(), scale)
    assert stage.calibration_forwards == 2 and stage._real_calibrated
    assert_scales_equal()  # refined on the first real batch
    # the init's weights let activations grow to hundreds, and the box decode
    # takes an exponential of them: only the scores are held to the JAX stage
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4, rtol=1e-3)
    assert got.boxes.shape == want.boxes.shape and got.keep.shape == want.keep.shape

    frozen = layers.act_scales(model)
    stage.RECALIB_EVERY = 3
    for _ in range(2):
        stage.dispatch(frames)
    assert stage.calibration_forwards == 2  # batches 1 and 2: no forward
    assert all(torch.equal(v, frozen[k]) for k, v in layers.act_scales(model).items())
    stage.dispatch(np.full_like(frames, 255))  # batch 3: the drift watch, a louder batch
    assert stage.calibration_forwards == 3
    grown = layers.act_scales(model)
    assert any(float(grown[k]) > float(frozen[k]) for k in frozen)
    stage.merge_act_scales({k: v * 2 for k, v in grown.items()})
    assert all(float(v) == 2 * float(grown[k]) for k, v in layers.act_scales(model).items())
    with pytest.raises(ValueError, match="does not fit the model"):
        DetectStage(cfg, RetinaFace(), device="cpu")


def test_visual_stage_calibrates_on_first_crops():
    gen = torch.Generator().manual_seed(2)
    model = layers.seeded_init_(EmotionResNet50(7, quant=True), gen).eval().requires_grad_(False)
    stage = VisualStage(model, TemporalLSTM(7).eval(), batch_size=4, device="cpu", quant="int8")
    assert stage.calibration_forwards == 1 and not stage._real_calibrated
    seeded = layers.act_scales(model)
    frames = torch.from_numpy(np.random.default_rng(7).integers(0, 255, (3, 96, 96, 3), np.uint8))
    idx, boxes = np.array([0, 2]), np.array([[10, 10, 80, 80], [5, 20, 60, 90]])
    probs, feats = stage.run_static_from_frames(frames, idx, boxes)
    assert probs.shape == (2, 7) and feats.shape == (2, 512)
    assert stage.calibration_forwards == 2 and stage._real_calibrated
    refined = layers.act_scales(model)
    assert all(float(refined[k]) >= float(seeded[k]) for k in seeded)
    stage.run_static_from_frames(frames, idx, boxes)
    assert stage.calibration_forwards == 2  # once per process
    stage._real_calibrated = False
    stage.ensure_calibrated_crops(np.zeros((0, 224, 224, 3), np.uint8))
    assert stage.calibration_forwards == 2  # no crops, no forward
    stage.ensure_calibrated_crops(np.full((1, 224, 224, 3), 200, np.uint8))
    assert stage.calibration_forwards == 3 and stage._real_calibrated
    with pytest.raises(ValueError, match="does not fit the static model"):
        VisualStage(EmotionResNet50(7), TemporalLSTM(7), device="cpu", quant="int8")


# ------------------------------------------------------ the shared extractor

@pytest.mark.parametrize("quant", ["none", "int8"])
def test_shared_extractor_matches_jax(quant):
    """``AudioStage`` with ``shared_extractor=True`` against the JAX stage: a
    6.3 s clip has full 4 s windows (from the per-clip normalised feature
    stream) and tail windows (the exact per-window path, mean padding).
    Conv biases are random: with the init's zero biases a mean-padded tail
    normalises to rounding noise. f32; the exact model's bounds. int8 adds the
    stages' calibration (noise seed, then the clip's first two windows) on
    both sides."""
    cfg = AudioConfig(batch_size=4, dtype="float32", shared_extractor=True, quant=quant)
    jcfg = JaxW2V2Config(**TINY_W2V2)
    variables = numpy_tree(randomize_stats(init_variables(
        JaxExprModel("v3", 8, jcfg), (jnp.zeros((1, 17000)),), 3), 3))
    wav = (np.random.default_rng(60).normal(size=int(6.3 * 16000)) * 0.1).astype(np.float32)
    want, want_meta = JaxAudioStage(variables, cfg, jcfg, dtype=jnp.float32).run_from_wav(wav, 25)
    model = port(ExprModel("v3", 8, Wav2Vec2Config(**TINY_W2V2, quant=quant == "int8")),
                 convert.expr_model(variables)).requires_grad_(False)
    stage = AudioStage(model, cfg, device="cpu")
    got, meta = stage.run_from_wav(wav, 25)
    n_full = sum(e - s >= 64000 for s, e in meta.spans)
    assert 0 < n_full < len(meta.spans) == len(want_meta.spans)
    assert stage.calibration_forwards == (2 if quant == "int8" else 0)
    np.testing.assert_array_equal(meta.frame_ids, want_meta.frame_ids)
    assert got.shape == want.shape == (len(meta.spans), 8)
    tol = dict(atol=5e-4, rtol=1e-3) if quant == "none" else dict(atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(got, want, **tol)
    # the shared stream approximates the exact path on the full windows; the
    # tail windows took the exact path (other batches: f32 sums in another order)
    stage.cfg = dataclasses.replace(cfg, shared_extractor=False)
    exact, _ = stage.run_from_wav(wav, 25)
    assert np.abs(exact[:n_full] - got[:n_full]).max() > 1e-4
    np.testing.assert_allclose(exact[n_full:], got[n_full:], atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- the slice as a whole

def int8_config(cfg: PipelineConfig, fused: bool = False,
                detector: bool = True) -> PipelineConfig:
    """``cli.run --serving_profile int8 [--fused]`` at the slice test's size."""
    return dataclasses.replace(
        cfg,
        detector=dataclasses.replace(cfg.detector, quant="int8" if detector else "none"),
        visual=dataclasses.replace(cfg.visual, quant="int8", fused=fused, fused_entries=fused),
        audio=dataclasses.replace(cfg.audio, quant="int8", shared_extractor=True))


@pytest.fixture(scope="module")
def int8_clip_runs(tmp_path_factory):
    import cv2

    tmp = tmp_path_factory.mktemp("slice_int8")
    rng = np.random.default_rng(0)
    video = str(tmp / "clip.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (W, H))
    for _ in range(N_FRAMES):
        vw.write(rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8))
    vw.release()
    # 4.6 s of audio: two full windows for the shared stream, eight tail windows
    wav = (rng.normal(size=int(4.6 * 16000)) * 0.1).astype(np.float32)
    jax_media.write_wav(str(tmp / "clip.wav"), wav, 16000)
    variables = {
        "emotion_resnet50": randomize_stats(init_variables(
            JaxEmotionResNet50(7), (jnp.zeros((1, 64, 64, 3)),), 1), 1),
        "temporal_lstm": init_variables(JaxTemporalLSTM(7), (jnp.zeros((1, 10, 512)),), 2),
        "expr_model": randomize_stats(init_variables(
            JaxExprModel("v3", 8, JaxW2V2Config(**TINY_W2V2)), (jnp.zeros((1, 17000)),), 3), 3),
    }
    runs = {}
    for fused in (False, True):
        # the stub detector stands in for the detect stage on both sides (the
        # int8 detect stage has its own test above)
        cfg = int8_config(slice_config(str(tmp / "no_weights")), fused, detector=False)
        jax_pipe = JaxPipeline(cfg, {}, variables["emotion_resnet50"],
                               variables["temporal_lstm"], variables["expr_model"],
                               JaxW2V2Config(**TINY_W2V2))
        jax_pipe.detect = JaxStubDetect()
        pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu",
                              jax_variables=variables)
        pipe.detect = PortStubDetect()
        runs[fused] = (jax_pipe.run(video, ""), pipe.run(video, ""), pipe)
    return runs


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_int8_slice_outputs_match_jax(int8_clip_runs, fused):
    """``Pipeline.run`` with ``quant="int8"`` in all three stages and the
    shared audio extractor on both sides, one synthetic clip, f32 compute
    dtype: each side seeds its scales on noise, refines them on the clip's
    first crops and windows, and serves. A value flipped between the two sides
    in a calibration or a serving forward moves a static probability by up to
    a few 1e-3 (int8 against exact moves it by 1e-2), so the bounds are ten
    times the bf16 slice test's; the LSTM's logits, sums over ten frames of
    512 features that each carry such moves, get 5e-2."""
    want, got, pipe = int8_clip_runs[fused]
    assert got.total_frames == want.total_frames == N_FRAMES
    np.testing.assert_allclose(got.stat_probs, want.stat_probs, atol=1e-3, rtol=1e-2)
    np.testing.assert_allclose(got.dyn_logits, want.dyn_logits, atol=5e-2, rtol=1e-1)
    np.testing.assert_allclose(got.audio_window_logits, want.audio_window_logits,
                               atol=5e-3, rtol=1e-2)
    np.testing.assert_array_equal(got.audio_frame_ids, want.audio_frame_ids)
    np.testing.assert_array_equal(got.face_boxes, want.face_boxes)
    assert pipe.visual.calibration_forwards == 2 and pipe.audio.calibration_forwards == 2
    assert pipe.visual.static_model.fused == fused


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_int8_slice_compound_decisions_match_jax(int8_clip_runs, fused):
    """Decisions are equal on every frame except near-ties: where the two
    best AV compound probabilities lie within the bound on ``av_prob`` of
    each other (without being equal), rounding may pick either."""
    want, got, _ = int8_clip_runs[fused]
    tol = 2e-3
    np.testing.assert_allclose(got.compound.av_prob, want.compound.av_prob, atol=tol)
    top2 = np.sort(want.compound.av_prob[:, :7], axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    decided = ~((gap > 0) & (gap <= 2 * tol))
    for key in ("av", "vs", "vd", "a"):
        g, w = getattr(got.compound, key), getattr(want.compound, key)
        np.testing.assert_array_equal(g[decided], w[decided], err_msg=key)
    assert decided.mean() > 0.5


def test_int8_slice_differs_from_exact(int8_clip_runs):
    """The int8 run is a different arithmetic from the exact one, not the
    exact path under another name; fused and unfused int8 agree closely."""
    (_, unfused, _), (_, fused, _) = int8_clip_runs[False], int8_clip_runs[True]
    np.testing.assert_allclose(fused.stat_probs, unfused.stat_probs, atol=1e-3, rtol=1e-2)
    np.testing.assert_array_equal(fused.audio_window_logits, unfused.audio_window_logits)


def test_cli_int8_profile():
    """``--serving_profile int8`` maps as the JAX package's CLI maps it:
    ``quant="int8"`` in all three stages, the r50 detector at the 640 bucket
    with batch 32, the shared extractor unless ``--exact_audio``; ``parity``
    is unchanged; every other quantised profile is int8 in all three stages
    too, ``balanced`` in none."""
    cfg = cli.config_from_args(cli.parse_args(["--serving_profile", "int8"]))
    assert (cfg.detector.quant, cfg.visual.quant, cfg.audio.quant) == ("int8",) * 3
    assert (cfg.detector.backbone, cfg.detector.long_side, cfg.detector.batch_size,
            cfg.detector.stride, cfg.visual.cnn_stride) == ("resnet50", 640, 32, 1, 1)
    assert cfg.audio.shared_extractor and not cfg.detector.fused_layer1
    cfg = cli.config_from_args(cli.parse_args(["--serving_profile", "int8", "--exact_audio",
                                               "--fused"]))
    assert not cfg.audio.shared_extractor and cfg.audio.quant == "int8"
    assert cfg.detector.fused_fpn and cfg.visual.fused_entries
    cfg = cli.config_from_args(cli.parse_args([]))
    assert (cfg.detector.quant, cfg.visual.quant, cfg.audio.quant) == ("none",) * 3
    assert not cfg.audio.shared_extractor
    for profile in ("balanced", "int8_s2", "int8_448", "int8_448_s2", "fast", "turbo", "max"):
        cfg = cli.config_from_args(cli.parse_args(["--serving_profile", profile]))
        want = "none" if profile == "balanced" else "int8"
        assert (cfg.detector.quant, cfg.visual.quant, cfg.audio.quant) == (want,) * 3
        assert cfg.audio.shared_extractor == (want == "int8")


def test_builder_int8_models_and_refusals(tmp_path, monkeypatch):
    """``build_pipeline`` builds the int8 variants the config names, seeds
    their scales, builds what the serving presets switch on, builds with
    ``calibrate=True`` (here from a cached record, so that the CPU measures
    nothing), and still refuses what does not exist."""
    cfg = int8_config(slice_config(str(tmp_path / "no_weights")), fused=True)
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu")
    det, cnn, aud = pipe.detect.model, pipe.visual.static_model, pipe.audio.model
    assert det.quant and cnn.quant and aud.wav2vec2.config.quant
    assert not det.fused_ssh and cnn.fused  # the switches are the config's
    for model in (det, cnn, aud):
        assert all(m.calibrated and m.dtype == torch.float32
                   for m in layers.q_modules(model).values())
    assert isinstance(det.body.conv1, torch.nn.Conv2d)  # the detector's stem stays exact
    assert isinstance(cnn.fc1, torch.nn.Linear)
    # the presets' switches build: detect stride, the mobilenet detector,
    # the CNN on the step cadence
    for ok in (dict(detector=dataclasses.replace(cfg.detector, stride=2)),
               dict(detector=dataclasses.replace(cfg.detector, backbone="mobilenet0.25")),
               dict(visual=dataclasses.replace(cfg.visual, cnn_stride=0))):
        c = dataclasses.replace(cfg, **ok)
        built = build_pipeline(c, Wav2Vec2Config(**TINY_W2V2), device="cpu")
        assert built.detect.model.backbone == c.detector.backbone and built.detect.model.quant
        assert built._new_tracker().gap_frames == c.detector.stride
    # the heatmaps and the host-crop path are served (tests/test_torch_cli_surface.py)
    check_supported(dataclasses.replace(cfg, heatmaps="static", save_face_crops=True))
    # --calibrate is served: the record cached for this CPU and configuration
    # is applied at build
    from types import SimpleNamespace
    from avcer_tpu_torch.pipeline import calibrate

    cache = tmp_path / "calibration.json"
    record = {"visual_batch": 4, "audio_batch": 2, "cnn_ms_per_frame": {"4": 1.0},
              "audio_ms_per_window": {"2": 1.0}}
    calibrated = dataclasses.replace(cfg, calibrate=True)
    key = calibrate._cache_key(SimpleNamespace(cfg=calibrated, device=torch.device("cpu")))
    cache.write_text(json.dumps({key: record}))
    monkeypatch.setattr(calibrate, "DEFAULT_CACHE", str(cache))
    built = build_pipeline(calibrated, Wav2Vec2Config(**TINY_W2V2), device="cpu")
    assert (built.visual.batch_size, built.audio.cfg.batch_size) == (4, 2)
    # a mesh of 2 is served since the parallelism slice: on the one CPU it
    # raises the mesh error
    for bad in (dict(heatmaps="bogus"), dict(mesh=dataclasses.replace(cfg.mesh, data=2)),
                dict(detector=dataclasses.replace(cfg.detector, stride=3))):
        with pytest.raises(ValueError,
                           match="not ported|must divide batch_size|mesh 2x1 exceeds 1 devices"):
            build_pipeline(dataclasses.replace(cfg, **bad), Wav2Vec2Config(**TINY_W2V2),
                           device="cpu")
