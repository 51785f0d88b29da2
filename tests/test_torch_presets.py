"""The serving presets of avcer_tpu_torch against the JAX package on the CPU:
the profile table of the CLI, the host helpers of ``cnn_stride`` serving, the
runner's box interpolation under a detect stride and its ``cnn_stride`` branch
across chunk boundaries (stub stages on both sides, equal results), the
``cnn_stride`` contract end to end (the dynamic stream bit-equal to per-frame
serving, exact and int8), ``run_many`` against serial runs, and the ``turbo``
and ``max`` profiles as a whole on one synthetic clip."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.core import config as jax_config
from avcer_tpu.core.config import pipeline_config_from_args
from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
from avcer_tpu.models.emotion_resnet import EmotionResNet50 as JaxEmotionResNet50
from avcer_tpu.models.temporal_lstm import TemporalLSTM as JaxTemporalLSTM
from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V2Config
from avcer_tpu.pipeline import visual as jax_visual
from avcer_tpu.pipeline.detect import DetectStage as JaxDetectStage
from avcer_tpu.pipeline.runner import Pipeline as JaxPipeline

import avcer_tpu_torch.cli.run as cli
from avcer_tpu_torch.core import config as port_config
from avcer_tpu_torch.core import registry
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.pipeline import runner as port_runner
from avcer_tpu_torch.pipeline import visual as port_visual
from avcer_tpu_torch.pipeline.builder import build_pipeline
from avcer_tpu_torch.pipeline.detect import DetectStage
from avcer_tpu_torch.pipeline.media import ArrayReader
from avcer_tpu_torch.pipeline.runner import Pipeline

from test_torch_models import TINY_W2V2, randomize_stats
from test_torch_pipeline import slice_config

torch.set_num_threads(2)


# ---------------------------------------------------------- the profile table

def _jax_config(argv):
    # an empty cache directory keeps the JAX CLI from turning its compile cache on
    return pipeline_config_from_args(argv + ["--compile_cache_dir", ""])[0]


def _assert_same_config(argv):
    got = dataclasses.asdict(cli.config_from_args(cli.parse_args(argv)))
    want = dataclasses.asdict(_jax_config(argv))
    assert got["detector"]["transfer_format"] == "i420"  # the JAX package's wire format
    # the port's own field, which the JAX CLI lacks: by default the JAX package's encoder
    assert got["audio"].pop("encoder") == "wav2vec2-large-robust-12"
    assert got == want
    return got


@pytest.mark.parametrize("profile", cli.PROFILES)
def test_profile_equals_jax_cli(profile):
    """``--serving_profile P`` alone, with ``--fused`` and with
    ``--exact_audio``: every field of the config equals what the JAX package's
    ``pipeline_config_from_args`` builds, ``transfer_format`` included."""
    base = _assert_same_config(["--serving_profile", profile])
    mobilenet = profile in ("fast", "turbo", "max")
    assert base["detector"]["backbone"] == ("mobilenet0.25" if mobilenet else "resnet50")
    assert base["detector"]["batch_size"] == (128 if mobilenet else 32)
    assert base["visual"]["cnn_stride"] == (0 if profile == "max" else 1)
    quant = "none" if profile in ("parity", "balanced") else "int8"
    assert {base[s]["quant"] for s in ("detector", "visual", "audio")} == {quant}
    assert base["audio"]["shared_extractor"] == (quant == "int8")
    fused = _assert_same_config(["--serving_profile", profile, "--fused"])
    assert fused["detector"]["fused_fpn"] and fused["visual"]["fused_entries"]
    exact = _assert_same_config(["--serving_profile", profile, "--exact_audio"])
    assert not exact["audio"]["shared_extractor"]


@pytest.mark.parametrize("argv,want", [
    (["--serving_profile", "turbo", "--long_side", "512", "--detect_stride", "4"], (512, 4, 1)),
    # an explicit flag equal to the default of the other presets still overrides
    (["--serving_profile", "turbo", "--long_side", "640", "--detect_stride", "1"], (640, 1, 1)),
    (["--serving_profile", "max", "--cnn_stride", "3"], (448, 2, 3)),
    (["--serving_profile", "parity", "--cnn_stride", "0", "--detect_stride", "2"], (640, 2, 0)),
    (["--serving_profile", "balanced", "--long_side", "0"], (0, 1, 1)),
    (["--serving_profile", "int8_448_s2", "--audio_step", "1.0", "--no_ce_mask",
      "--ce_weights_type", "--no_published_weights", "--audio_padding", "repeat"], (448, 2, 1)),
], ids=["turbo_512_s4", "turbo_640_s1", "max_cnn3", "parity_strided", "balanced_native",
        "int8_448_s2_flags"])
def test_explicit_flags_override_the_preset(argv, want):
    got = _assert_same_config(argv)
    assert (got["detector"]["long_side"], got["detector"]["stride"],
            got["visual"]["cnn_stride"]) == want


def test_cli_refusals_that_remain():
    """A negative ``cnn_stride`` fails at config time, as in the JAX package;
    an unknown profile is refused while parsing; ``--calibrate`` parses into
    the configuration; and the default device never falls back to the CPU."""
    with pytest.raises(ValueError, match="cnn_stride"):
        cli.config_from_args(cli.parse_args(["--cnn_stride", "-5"]))
    with pytest.raises(SystemExit):
        cli.parse_args(["--serving_profile", "x"])
    assert cli.config_from_args(cli.parse_args(["--calibrate"])).calibrate
    # ported: the mesh of --data_parallel; too few devices raise at build
    assert cli.config_from_args(cli.parse_args(["--data_parallel", "2"])).mesh.data == 2
    assert cli.config_from_args(cli.parse_args(["--heatmaps", "static"])).heatmaps == "static"
    assert cli.parse_args([]).device == "cuda"


# ------------------------------------------------- cnn_stride's host helpers

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cnn_stride_helpers_equal_originals(seed):
    """``cnn_compute_sel`` and ``subset_forward_fill`` against the JAX
    package's, on sparse random presence, in one shot and chunked with the
    carries; the staleness bound holds in frame-id space."""
    rng = np.random.default_rng(seed)
    gids = np.flatnonzero(rng.random(90) < (0.9, 0.6, 0.35, 0.15)[seed])
    step, cs = (5, 4, 3, 6)[seed], (4, 5, 7, 2)[seed]
    want_sel, want_last = jax_visual.cnn_compute_sel(gids, step, cs)
    sel, last = port_visual.cnn_compute_sel(gids, step, cs)
    np.testing.assert_array_equal(sel, want_sel)
    assert last == want_last and sel[0]
    held = np.maximum.accumulate(np.where(sel, gids, -10 ** 9))
    assert int(np.max(gids - held)) < cs and sel[gids % step == 0].all()

    rows = rng.normal(size=(int(sel.sum()), 3)).astype(np.float32)
    want_fill, want_carry = jax_visual.subset_forward_fill(sel, rows, None)
    fill, carry = port_visual.subset_forward_fill(sel, rows, None)
    np.testing.assert_array_equal(fill, want_fill)
    np.testing.assert_array_equal(carry, want_carry)

    # chunked, carrying prev_gid and the last filled row, equals one shot
    split = len(gids) // 2
    s1, l1 = port_visual.cnn_compute_sel(gids[:split], step, cs)
    s2, l2 = port_visual.cnn_compute_sel(gids[split:], step, cs, l1)
    np.testing.assert_array_equal(np.concatenate([s1, s2]), sel)
    assert l2 == last
    n1 = int(s1.sum())
    f1, c1 = port_visual.subset_forward_fill(s1, rows[:n1], None)
    f2, c2 = port_visual.subset_forward_fill(s2, rows[n1:], c1)
    np.testing.assert_array_equal(np.concatenate([f1, f2]), fill)
    np.testing.assert_array_equal(c2, carry)


def test_cnn_stride_helpers_edges():
    """A chunk with no computed row holds the carry throughout; an empty chunk
    returns the carry; leading unselected rows without a carry raise on both
    sides."""
    carry = np.arange(3, dtype=np.float32)
    for mod in (port_visual, jax_visual):
        f, c = mod.subset_forward_fill(np.zeros(4, bool), np.zeros((0, 3), np.float32), carry)
        np.testing.assert_array_equal(f, np.tile(carry[None], (4, 1)))
        np.testing.assert_array_equal(c, carry)
        f, c = mod.subset_forward_fill(np.zeros(0, bool), np.zeros((0, 3), np.float32), carry)
        assert f.shape == (0, 3) and c is carry
        with pytest.raises(ValueError):
            mod.subset_forward_fill(np.array([False, True]), np.zeros((1, 3), np.float32), None)
        sel, last = mod.cnn_compute_sel(np.zeros(0, np.int64), 5, 3, 17)
        assert sel.shape == (0,) and last == 17


# --------------------------------- the runner with stub stages on both sides

class FakeReader:
    """Frames whose pixels carry their global frame index (two channels)."""

    def __init__(self, n_frames: int, h: int = 96, w: int = 128):
        self.n, self.h, self.w = n_frames, h, w
        self.meta = type("meta", (), dict(width=w, height=h, fps=25, total_frames=n_frames,
                                          path="fake.avi"))

    def batches(self, batch_size):
        for s in range(0, self.n, batch_size):
            n = min(batch_size, self.n - s)
            ids = s + np.minimum(np.arange(batch_size), n - 1)
            frames = np.zeros((batch_size, 8, 8, 3), np.uint8)
            frames[..., 0] = (ids % 256)[:, None, None]
            frames[..., 1] = (ids // 256)[:, None, None]
            yield frames, n

    def release(self):
        pass


def stub_box(ids: np.ndarray) -> np.ndarray:
    """A face at the frame's left edge that drifts and breathes: fractional,
    non-linear coordinates, so interpolated boxes fall anywhere between the
    integers; where its right edge comes within a pixel of the border the
    int-cast, clamped box is degenerate and the frame has no face, while the
    tracker keeps the identity (an emptied frame would end tracklet 1 for the
    rest of the clip, as in the reference)."""
    i = ids.astype(np.float64)
    x1 = -36.1 + 0.003 * i + 5.0 * np.sin(i / 4.0)
    y1 = 20.7 + 6.0 * np.cos(i / 5.0) + 0.37 * (i % 11)
    return np.stack([x1, y1, x1 + 40.2, y1 + 38.9 + np.sin(i / 2.0)], axis=1)


class JaxStridedStub:
    """Emits the tracked box of every stride-th frame."""

    def __init__(self, stride: int):
        self.stride = stride

    def _packed(self, frames):
        det = frames[::self.stride]
        ids = det[:, 0, 0, 0].astype(np.int64) + 256 * det[:, 0, 0, 1].astype(np.int64)
        packed = np.zeros((det.shape[0], 4, 16), np.float32)
        packed[:, 0, 0:4] = stub_box(ids)
        packed[:, 0, 4] = 0.95
        packed[:, 0, 5] = 1.0
        return packed

    def dispatch(self, frames):
        return self._packed(frames), 1.0, jnp.asarray(frames)

    def unpack(self, packed_np, scale):
        return JaxDetectStage.unpack(packed_np, scale)


class PortStridedStub(JaxStridedStub):
    def dispatch(self, frames):
        return torch.from_numpy(self._packed(frames)), 1.0, torch.from_numpy(frames)

    def unpack(self, packed_np, scale):
        return DetectStage.unpack(packed_np, scale)


class FakeVisual:
    """Records what the CNN would see; rows carry the chunk-local frame index
    and the crop box."""

    def __init__(self):
        self.idx, self.boxes, self.calibrated_on = [], [], []

    def ensure_calibrated_from_frames(self, frames_dev, idx, boxes):
        self.calibrated_on.append(np.array(idx[:8]))

    def run_static_from_frames(self, frames_dev, idx, boxes):
        self.idx.append(np.array(idx))
        self.boxes.append(np.array(boxes))
        rows = np.concatenate([np.array(idx, np.float32)[:, None], np.array(boxes, np.float32)], 1)
        return np.tile(rows, (1, 2))[:, :7], np.tile(rows, (1, 103))[:, :512]


def run_both(cfg_kw: dict, n_frames: int, stride: int, cnn_step=None):
    out = []
    for mod, pipeline, stub in ((jax_config, JaxPipeline, JaxStridedStub),
                                (port_config, Pipeline, PortStridedStub)):
        pipe = pipeline.__new__(pipeline)  # the stages are put in by hand
        pipe.cfg = mod.PipelineConfig(
            detector=mod.DetectorConfig(long_side=0, stride=stride, **cfg_kw.get("detector", {})),
            visual=mod.VisualConfig(**cfg_kw.get("visual", {})))
        pipe.detect = stub(stride)
        pipe.visual = FakeVisual()
        res = pipe.detect_track_device(FakeReader(n_frames), cnn_step=cnn_step)
        present, stat, feats, face_boxes = res[0], res[1], res[2], res[-1]
        out.append((present, stat, feats, face_boxes, pipe.visual))
    return out


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_detect_stride_box_interpolation_equals_jax(stride):
    """Boxes between detections are the linear interpolation of their
    neighbours, held at the chunk's tail, then int-cast and clamped: the
    port's ``face_boxes``, presence and crop boxes equal the JAX runner's on a
    face with fractional non-linear motion that leaves the frame now and then.
    45 frames in batches of 8: the last batch is padded."""
    n = 45
    (jp, _, _, jb, jv), (pp, _, _, pb, pv) = run_both(dict(detector=dict(batch_size=8)), n, stride)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pb, jb)
    assert pb.dtype == np.int32 and pb.shape == (n, 4)
    np.testing.assert_array_equal(np.concatenate(pv.idx), np.concatenate(jv.idx))
    np.testing.assert_array_equal(np.concatenate(pv.boxes), np.concatenate(jv.boxes))
    assert 0.5 < pp.mean() < 1 and (pb[~pp] == -1).all() and (pb[pp] >= 0).all()
    own = stub_box(np.arange(n))
    if stride == 1:  # every frame its own detection: the reference's int cast and clamp
        np.testing.assert_array_equal(pp, own[:, 2].astype(np.int32) > 0)
        np.testing.assert_array_equal(pb[pp, 1:], own[pp, 1:].astype(np.int32))
        assert (pb[pp, 0] == 0).all()
    else:  # strictly between two detections the box lies between theirs
        d = np.arange(n) // stride * stride
        mid = np.flatnonzero(pp & (np.arange(n) % stride != 0) & (d + stride < n))
        lo, hi = own[d[mid]], own[d[mid] + stride]
        assert mid.size > 5
        assert ((pb[mid, 1:] >= np.floor(np.minimum(lo, hi))[:, 1:])
                & (pb[mid, 1:] <= np.ceil(np.maximum(lo, hi))[:, 1:])).all()
        # past the last detection the box is held
        tail = np.flatnonzero(np.arange(n) > (n - 1) // stride * stride)
        assert (pb[tail] == pb[(n - 1) // stride * stride]).all()


@pytest.mark.parametrize("stride,cs", [(1, 3), (2, 0), (1, 7)], ids=["cs3", "s2_step", "cs7"])
def test_cnn_stride_device_path_equals_jax_across_chunks(stride, cs):
    """``detect_track_device`` under ``cnn_stride`` over 1100 frames in
    batches of 64: three chunks (512 + 512 + 76 frames), so ``cnn_prev_gid``
    and the held rows cross two chunk boundaries, with the face absent now and
    then. The CNN sees only the selected frames, the returned rows are their
    forward fill, step frames are always computed, and all of it equals the
    JAX runner's; the int8 calibration hook sees each chunk's leading present
    frames before the subset is taken."""
    n, step = 1100, 5
    (jp, js, jf, jb, jv), (pp, ps, pf, pb, pv) = run_both(
        dict(detector=dict(batch_size=64), visual=dict(cnn_stride=cs)), n, stride, cnn_step=step)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pf, jf)
    assert len(pv.idx) == len(jv.idx) == 3 and 0.5 < pp.mean() < 0.95
    for a, b in zip(pv.idx, jv.idx):
        np.testing.assert_array_equal(a, b)
    gids = np.flatnonzero(pp)
    sel, _ = port_visual.cnn_compute_sel(gids, step, cs or step)
    assert 0 < sel.sum() < len(gids)
    chunk_of = gids // 512
    computed = np.concatenate([i + 512 * c for c, i in enumerate(pv.idx)])
    np.testing.assert_array_equal(computed, gids[sel])
    held = gids[sel][np.cumsum(sel) - 1]  # the last computed frame at or before each
    np.testing.assert_array_equal(ps[:, 0], (held % 512).astype(np.float32))
    np.testing.assert_array_equal(pf[:, 0], (held % 512).astype(np.float32))
    assert int(np.max(gids - held)) < (cs or step) and sel[gids % step == 0].all()
    assert (held // 512 != chunk_of).any() or cs == 0  # rows held across a chunk boundary
    for c, first in enumerate(pv.calibrated_on):
        np.testing.assert_array_equal(first, (gids[chunk_of == c] % 512)[:8])


@pytest.mark.parametrize("cs", [0, 3])
def test_cnn_stride_without_step_cadence_raises(cs):
    """``cnn_stride`` other than 1 selects frames by the clip's dynamic step
    cadence: without ``cnn_step`` the port refuses, it does not serve every
    frame in silence."""
    pipe = Pipeline.__new__(Pipeline)
    pipe.cfg = port_config.PipelineConfig(
        detector=port_config.DetectorConfig(long_side=0, batch_size=8),
        visual=port_config.VisualConfig(cnn_stride=cs))
    pipe.detect, pipe.visual = PortStridedStub(1), FakeVisual()
    with pytest.raises(ValueError, match="cnn_step"):
        pipe.detect_track_device(FakeReader(16))
    assert not pipe.visual.idx


# ------------------------------------------- cnn_stride end to end in the port

def tiny_clip(n_frames: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, size=(n_frames, 96, 96, 3), dtype=np.uint8)
    wav = (rng.normal(size=int(1.5 * 16000)) * 0.1).astype(np.float32)
    return frames, wav


class PortCentredStub:
    """One centred face on every detected frame, none on ``absent`` ones."""

    def __init__(self, stride: int = 1, absent=()):
        self.stride, self.absent, self.seen = stride, set(absent), 0

    def dispatch(self, frames):
        det = frames[::self.stride]
        packed = np.zeros((det.shape[0], 8, 16), np.float32)
        packed[:, 0, 0:4] = [24.0, 24.0, 72.0, 72.0]
        packed[:, 0, 4] = 0.95
        ids = self.seen + np.arange(det.shape[0]) * self.stride
        packed[:, 0, 5] = [0.0 if int(i) in self.absent else 1.0 for i in ids]
        self.seen += frames.shape[0]
        return torch.from_numpy(packed), 1.0, torch.from_numpy(frames)

    def unpack(self, packed_np, scale):
        return DetectStage.unpack(packed_np, scale)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cnn_stride_end_to_end_equivalence(tmp_path, monkeypatch, quant):
    """The whole tiny pipeline, per-frame serving against ``cnn_stride = 0``
    (the ``max`` preset's setting) on the same clip, two pipelines built from
    the same seed: the dynamic stream is bit-equal, static rows at computed
    frames are bit-equal, skipped frames hold the previous computed row. The
    chunk is shrunk to 8 frames, so the 22-frame clip crosses two chunk
    boundaries; the face appears on frame 3, which is no step frame and is
    computed all the same. In int8 each pipeline refines
    its own scales: they agree only because the strided path calibrates on the
    same leading crops as the per-frame path, before it takes the subset."""
    monkeypatch.setattr(port_runner, "CHUNK_FRAMES", 8)
    frames, wav = tiny_clip(22)
    cfg = slice_config(str(tmp_path / "no_weights"))
    cfg = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, batch_size=4),
        visual=dataclasses.replace(cfg.visual, quant=quant), save_probs=False)
    runs = []
    for cs in (1, 0):
        c = dataclasses.replace(cfg, visual=dataclasses.replace(cfg.visual, cnn_stride=cs))
        pipe = build_pipeline(c, Wav2Vec2Config(**TINY_W2V2), device="cpu", seed=3)
        pipe.detect = PortCentredStub(absent={0, 1, 2})
        asked = []  # crops the runner asked the CNN for, per chunk

        def run_static(f, idx, b, inner=pipe.visual.run_static_from_frames, asked=asked):
            asked.append(len(idx))
            return inner(f, idx, b)

        pipe.visual.run_static_from_frames = run_static
        runs.append((pipe.run(ArrayReader(frames, 25), "", wav=wav), pipe, asked))
    (base, base_pipe, base_asked), (got, pipe, asked) = runs
    step = registry.dynamic_step(25)
    present = np.arange(22) >= 3
    np.testing.assert_array_equal(got.face_boxes, base.face_boxes)
    np.testing.assert_array_equal(got.dyn_logits, base.dyn_logits)
    gids = np.flatnonzero(present)
    sel, _ = port_visual.cnn_compute_sel(gids, step, step)
    np.testing.assert_array_equal(got.stat_probs[gids[sel]], base.stat_probs[gids[sel]])
    held = gids[sel][np.cumsum(sel) - 1]
    np.testing.assert_array_equal(got.stat_probs[gids], base.stat_probs[held])
    assert not np.array_equal(got.stat_probs, base.stat_probs)
    # the CNN was asked for the subset only
    assert sum(base_asked) == 19 and sum(asked) == int(sel.sum()) == 5
    if quant == "int8":
        assert pipe.visual.calibration_forwards == base_pipe.visual.calibration_forwards == 2


def test_static_batches_have_one_shape(tmp_path):
    """The CNN always sees ``batch_size`` crops (the last sub-batch filled up
    by repeating its last crop), so a crop's row does not depend on how many
    crops came with it: the rows of 5 crops equal the first 5 rows of 7."""
    cfg = slice_config(str(tmp_path / "no_weights"))
    cfg = dataclasses.replace(cfg, visual=dataclasses.replace(cfg.visual, batch_size=4))
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu", seed=5)
    shapes = []
    pipe.visual.static_model.register_forward_hook(lambda m, a, o: shapes.append(a[0].shape[0]))
    frames = torch.from_numpy(tiny_clip(7, seed=9)[0])
    boxes = np.tile(np.array([[20, 20, 70, 76]]), (7, 1)) + np.arange(7)[:, None]
    p7, f7 = pipe.visual.run_static_from_frames(frames, np.arange(7), boxes)
    p5, f5 = pipe.visual.run_static_from_frames(frames, np.arange(5), boxes[:5])
    assert shapes == [4, 4, 4, 4] and p7.shape == (7, 7) and f5.shape == (5, 512)
    np.testing.assert_array_equal(p5, p7[:5])
    np.testing.assert_array_equal(f5, f7[:5])


# ------------------------------------------------------------------ run_many

def test_run_many_equals_serial_runs(tmp_path):
    """Three clips through ``run_many`` with two in flight: each clip's
    results equal its serial run's, in the order given, and the output tree
    holds every clip's files."""
    cfg = dataclasses.replace(slice_config(str(tmp_path / "no_weights")), save_plot=False)
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu", seed=4)

    class Stub(PortCentredStub):  # stateless: clips overlap
        def dispatch(self, frames):
            self.seen = 0
            return super().dispatch(frames)

    pipe.detect = Stub()
    from avcer_tpu_torch.pipeline import media

    readers = []
    for i, n in enumerate((9, 6, 11)):
        frames, wav = tiny_clip(n, seed=20 + i)
        media.write_wav(str(tmp_path / f"clip{i}.wav"), wav, 16000)
        readers.append(lambda f=frames, i=i: ArrayReader(f, 25, str(tmp_path / f"clip{i}.avi")))
    serial = [pipe.run(r(), "") for r in readers]
    many = pipe.run_many([r() for r in readers], str(tmp_path / "out"), overlap=2)
    one = pipe.run_many([readers[0]()], "", overlap=2)
    assert [c.name_video for c in many] == ["clip0", "clip1", "clip2"]
    for got, want in zip(many + one, serial + serial[:1]):
        assert got.total_frames == want.total_frames
        for key in ("stat_probs", "dyn_logits", "audio_window_logits", "face_boxes"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
        np.testing.assert_array_equal(got.compound.av, want.compound.av)
    files = sorted(p.name for p in (tmp_path / "out").rglob("*") if p.is_file())
    assert len(files) == 12 and {f"static__clip{i}.csv" for i in range(3)} <= set(files)


# ------------------------------------------- turbo and max as a whole vs JAX

class JaxCentredStub:
    def __init__(self, stride: int):
        self.stride = stride

    def dispatch(self, frames):
        det = frames[::self.stride]
        packed = np.zeros((det.shape[0], 8, 16), np.float32)
        packed[:, 0, 0:4] = [24.0, 24.0, 72.0, 72.0]
        packed[:, 0, 4] = 0.95
        packed[:, 0, 5] = 1.0
        return packed, 1.0, jnp.asarray(frames)

    def unpack(self, packed_np, scale):
        return JaxDetectStage.unpack(packed_np, scale)


def preset_config(profile: str, weights_dir: str):
    """``cli.run --serving_profile turbo|max`` at the slice test's size. The
    stub detector stands in for the detect stage on both sides, so its int8
    model is left out (tests/test_torch_mobilenet.py holds it to the JAX
    stage); everything downstream is the preset's: detect stride 2 with the
    gap-mode tracker and interpolated boxes, the int8 CNN, the int8 audio model
    with the shared extractor, and for ``max`` the CNN on the step cadence."""
    c = cli.config_from_args(cli.parse_args(["--serving_profile", profile]))
    assert (c.detector.stride, c.detector.backbone, c.detector.long_side) == (
        2, "mobilenet0.25", 448)
    return dataclasses.replace(
        c, detector=dataclasses.replace(c.detector, batch_size=8, long_side=64, quant="none",
                                        dtype="float32"),
        visual=dataclasses.replace(c.visual, batch_size=16, dtype="float32"),
        audio=dataclasses.replace(c.audio, batch_size=4, dtype="float32"),
        weights_dir=weights_dir, save_plot=False)


@pytest.fixture(scope="module")
def preset_runs(tmp_path_factory):
    import cv2

    from avcer_tpu_torch.pipeline import media

    tmp = tmp_path_factory.mktemp("presets")
    video = str(tmp / "clip.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 25, (96, 96))
    for frame in tiny_clip(30)[0]:
        vw.write(frame)
    vw.release()
    # 4.6 s of audio: two full windows for the shared stream, eight tail windows
    wav = (np.random.default_rng(1).normal(size=int(4.6 * 16000)) * 0.1).astype(np.float32)
    media.write_wav(str(tmp / "clip.wav"), wav, 16000)
    variables = {
        "emotion_resnet50": randomize_stats(init_variables(
            JaxEmotionResNet50(7), (jnp.zeros((1, 64, 64, 3)),), 1), 1),
        "temporal_lstm": init_variables(JaxTemporalLSTM(7), (jnp.zeros((1, 10, 512)),), 2),
        "expr_model": randomize_stats(init_variables(
            JaxExprModel("v3", 8, JaxW2V2Config(**TINY_W2V2)), (jnp.zeros((1, 17000)),), 3), 3),
    }
    cfg = preset_config("turbo", str(tmp / "no_weights"))
    jax_pipe = JaxPipeline(cfg, {}, variables["emotion_resnet50"], variables["temporal_lstm"],
                           variables["expr_model"], JaxW2V2Config(**TINY_W2V2))
    jax_pipe.detect = JaxCentredStub(2)
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu", jax_variables=variables)
    pipe.detect = PortCentredStub(2)
    runs = {}
    for profile in ("turbo", "max"):
        # the same two pipelines serve both profiles: ``max`` differs from
        # ``turbo`` in ``cnn_stride`` alone, which the runner reads per run
        cfg = preset_config(profile, str(tmp / "no_weights"))
        jax_pipe.cfg = pipe.cfg = cfg
        pipe.detect.seen = 0
        runs[profile] = (jax_pipe.run(video, ""), pipe.run(video, ""))
    return runs


@pytest.mark.parametrize("profile", ["turbo", "max"])
def test_preset_slice_outputs_match_jax(preset_runs, profile):
    """Bounds of the int8 slice test (tests/test_torch_int8_pipeline.py): a
    value flipped between the two sides moves a static probability by up to a
    few 1e-3, the LSTM's logits by more. ``face_boxes`` are equal."""
    want, got = preset_runs[profile]
    assert got.total_frames == want.total_frames == 30
    np.testing.assert_array_equal(got.face_boxes, want.face_boxes)
    np.testing.assert_allclose(got.stat_probs, want.stat_probs, atol=1e-3, rtol=1e-2)
    np.testing.assert_allclose(got.dyn_logits, want.dyn_logits, atol=5e-2, rtol=1e-1)
    np.testing.assert_allclose(got.audio_window_logits, want.audio_window_logits,
                               atol=5e-3, rtol=1e-2)
    np.testing.assert_array_equal(got.audio_frame_ids, want.audio_frame_ids)


@pytest.mark.parametrize("profile", ["turbo", "max"])
def test_preset_slice_compound_decisions_match_jax(preset_runs, profile):
    """Decisions equal the JAX run's on every frame except near-ties: where
    the two best AV compound probabilities lie within twice the bound on
    ``av_prob`` of each other without being equal."""
    want, got = preset_runs[profile]
    tol = 2e-3
    np.testing.assert_allclose(got.compound.av_prob, want.compound.av_prob, atol=tol)
    top2 = np.sort(want.compound.av_prob[:, :7], axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    decided = ~((gap > 0) & (gap <= 2 * tol))
    for key in ("av", "vs", "vd", "a"):
        np.testing.assert_array_equal(getattr(got.compound, key)[decided],
                                      getattr(want.compound, key)[decided], err_msg=key)
    assert decided.mean() > 0.5


def test_max_dynamic_stream_equals_turbo(preset_runs):
    """``max`` is ``turbo`` with the static CNN on the step cadence: its
    dynamic stream and boxes are turbo's bit for bit, on both sides; its
    static rows are turbo's at the computed frames and held between."""
    for side in (0, 1):
        turbo, mx = preset_runs["turbo"][side], preset_runs["max"][side]
        np.testing.assert_array_equal(mx.dyn_logits, turbo.dyn_logits)
        np.testing.assert_array_equal(mx.face_boxes, turbo.face_boxes)
        np.testing.assert_array_equal(mx.audio_window_logits, turbo.audio_window_logits)
        step = registry.dynamic_step(25)
        held = np.arange(30) // step * step
        np.testing.assert_array_equal(mx.stat_probs, turbo.stat_probs[held])
