"""avcer_tpu_torch ops and host helpers against their avcer_tpu counterparts:
image, boxes, candidate selection, audio windows, fusion, the temporal plan
and wav I/O. Inputs come from numpy with a seed; tolerances are stated."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avcer_tpu.core.config import AudioConfig, FusionConfig
from avcer_tpu.fusion import compound as jax_compound
from avcer_tpu.ops import audio as jax_audio
from avcer_tpu.ops import boxes as jax_boxes
from avcer_tpu.ops import fusion as jax_fusion
from avcer_tpu.ops import image as jax_image
from avcer_tpu.ops import nms as jax_nms
from avcer_tpu.pipeline import audio_stage as jax_audio_stage
from avcer_tpu.pipeline import media as jax_media
from avcer_tpu.pipeline import visual as jax_visual

from avcer_tpu_torch.fusion import compound
from avcer_tpu_torch.ops import audio, boxes, fusion, image, nms
from avcer_tpu_torch.pipeline import audio_stage, media, visual

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# image
# --------------------------------------------------------------------------


@pytest.mark.parametrize("out_size,in_size", [(224, 100), (224, 224), (224, 517), (7, 3), (64, 63)])
def test_nearest_indices_bit_exact(out_size, in_size):
    np.testing.assert_array_equal(image.nearest_indices_np(out_size, in_size),
                                  jax_image.nearest_indices_np(out_size, in_size))


def test_nearest_indices_match_pil():
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 255, (37, 53, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((224, 224), Image.NEAREST))
    ri, ci = image.nearest_indices_np(224, 37), image.nearest_indices_np(224, 53)
    np.testing.assert_array_equal(img[ri[:, None], ci[None, :]], want)


@pytest.mark.parametrize("seed", [0, 1])
def test_crop_and_resize_equals_onehot(seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (5, 40, 56, 3), dtype=np.uint8)
    idx = rng.integers(0, 5, 6).astype(np.int32)
    x1 = rng.integers(0, 50, 6)
    y1 = rng.integers(0, 35, 6)
    bxs = np.stack([x1, y1, x1 + rng.integers(1, 30, 6), y1 + rng.integers(1, 30, 6)],
                   axis=1).astype(np.int32)
    bxs[0] = [10, 10, 10, 10]  # degenerate: clamps to one source pixel
    want = np.asarray(jax_image.crop_and_resize_onehot(
        jnp.asarray(frames), jnp.asarray(idx), jnp.asarray(bxs), 24))
    got = image.crop_and_resize(torch.from_numpy(frames), torch.from_numpy(idx),
                                torch.from_numpy(bxs), 24)
    np.testing.assert_array_equal(got.numpy(), want)


def test_normalizations_equal_jax():
    frames = np.random.default_rng(2).integers(0, 255, (2, 8, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        image.retinaface_normalize(torch.from_numpy(frames)).numpy(),
        np.asarray(jax_image.retinaface_normalize(jnp.asarray(frames))))
    np.testing.assert_array_equal(
        image.vggface_normalize(torch.from_numpy(frames)).numpy(),
        np.asarray(jax_image.vggface_normalize(jnp.asarray(frames))))


@pytest.mark.parametrize("hw", [(360, 640), (100, 130), (481, 271), (64, 64)])
def test_letterbox_params_equal_jax(hw):
    for long_side in (640, 448, 64):
        assert image.letterbox_params(*hw, long_side) == jax_image.letterbox_params(*hw, long_side)


@pytest.mark.parametrize("src_hw,dst_hw", [((100, 130), (50, 64)), ((360, 640), (360, 640)),
                                           ((270, 480), (360, 640)), ((720, 1280), (360, 640))])
def test_device_letterbox_within_one_lsb_of_cv2(src_hw, dst_hw):
    import cv2

    frames = np.random.default_rng(3).integers(0, 255, (2, *src_hw, 3), dtype=np.uint8)
    got = image.resize_bilinear_uint8(torch.from_numpy(frames), *dst_hw).numpy()
    want = np.stack([cv2.resize(f, dst_hw[::-1], interpolation=cv2.INTER_LINEAR)
                     for f in frames])
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_clamp_boxes_valid_equals_jax():
    rng = np.random.default_rng(4)
    b = rng.uniform(-20, 120, (50, 5)).astype(np.float32)
    got, ok = image.clamp_boxes_valid(b, 100, 80)
    want, want_ok = jax_image.clamp_boxes_valid(b, 100, 80)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, want_ok)


# --------------------------------------------------------------------------
# boxes and candidates
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (360, 640), (48, 64), (45, 37)])
def test_prior_boxes_equal_jax(hw):
    np.testing.assert_array_equal(boxes.prior_boxes(hw), jax_boxes.prior_boxes(hw))


def test_decode_equals_jax():
    rng = np.random.default_rng(5)
    priors = boxes.prior_boxes((64, 48))
    loc = rng.normal(size=(2, priors.shape[0], 4)).astype(np.float32)
    ldm = rng.normal(size=(2, priors.shape[0], 10)).astype(np.float32)
    p = torch.from_numpy(priors.copy())
    np.testing.assert_allclose(
        boxes.decode_boxes(torch.from_numpy(loc), p).numpy(),
        np.asarray(jax_boxes.decode_boxes(jnp.asarray(loc), jnp.asarray(priors))),
        atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(
        boxes.decode_landmarks(torch.from_numpy(ldm), p).numpy(),
        np.asarray(jax_boxes.decode_landmarks(jnp.asarray(ldm), jnp.asarray(priors))),
        atol=1e-7, rtol=1e-6)


def test_iou_matrix_equals_jax():
    rng = np.random.default_rng(6)
    b = rng.uniform(0, 100, (3, 16, 4)).astype(np.float32)
    b[..., 2:] += b[..., :2]
    np.testing.assert_array_equal(nms.iou_matrix_legacy(torch.from_numpy(b)).numpy(),
                                  np.asarray(jax_boxes.iou_matrix_legacy(jnp.asarray(b))))


@pytest.mark.parametrize("k", [4, 64])
def test_topk_candidates_ties_lower_index_first(k):
    rng = np.random.default_rng(7)
    scores = rng.integers(0, 5, (3, 100)).astype(np.float32) / 5  # many exact ties
    bx = rng.uniform(0, 50, (3, 100, 4)).astype(np.float32)
    got = nms.topk_candidates(torch.from_numpy(bx), torch.from_numpy(scores), k, 0.5)
    want = jax_nms.topk_candidates(jnp.asarray(bx), jnp.asarray(scores), k, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# audio
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 24000, 64000, 71999])
def test_window_enumeration_equals_jax(n):
    assert audio.enumerate_windows(n, 64000, 8000) == jax_audio.enumerate_windows(n, 64000, 8000)
    cfg = AudioConfig()
    got = audio_stage.make_windows(n, cfg, 25)
    want = jax_audio_stage.make_windows(np.zeros(n, np.float32), cfg, 25)
    assert got.spans == want.spans
    np.testing.assert_array_equal(got.frame_ids, want.frame_ids)
    np.testing.assert_array_equal(got.window_of_row, want.window_of_row)


@pytest.mark.parametrize("padding", ["mean", "constant", "repeat"])
def test_extract_windows_equals_jax(padding):
    wav = np.random.default_rng(8).normal(size=30001).astype(np.float32)
    window, step = 16000, 4000
    want = jax_audio.extract_windows(wav, window, step, padding)
    starts = torch.tensor([s for s, _ in audio.enumerate_windows(len(wav), window, step)])
    wav_dev = torch.from_numpy(np.pad(wav, (0, window + 1)))
    got = audio.extract_windows(wav_dev, len(wav), starts, window, padding)
    # "mean" sums 16000 samples in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_feature_extractor_normalize_equals_jax():
    x = (np.random.default_rng(9).normal(size=(3, 16000)) * 0.2 + 0.05).astype(np.float32)
    np.testing.assert_allclose(
        audio.feature_extractor_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_audio.feature_extractor_normalize(jnp.asarray(x))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("orig", [16000, 44100, 8000])
def test_resample_and_mixdown_equal_jax(orig):
    wav = np.random.default_rng(10).normal(size=(2, 4410)).astype(np.float32)
    mono = audio.mixdown_mono(wav)
    np.testing.assert_array_equal(mono, jax_audio.mixdown_mono(wav))
    np.testing.assert_allclose(audio.resample(mono, orig, 16000),
                               jax_audio.resample(mono, orig, 16000), atol=1e-6)


def test_wav_io_equals_jax(tmp_path):
    wav = (np.random.default_rng(11).normal(size=(2, 3000)) * 0.3).astype(np.float32)
    media.write_wav(str(tmp_path / "a.wav"), wav, 44100)
    jax_media.write_wav(str(tmp_path / "b.wav"), wav, 44100)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    got, sr = media.read_wav(str(tmp_path / "a.wav"))
    want, want_sr = jax_media.read_wav(str(tmp_path / "a.wav"))
    assert sr == want_sr == 44100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(media.extract_audio(str(tmp_path / "a.wav")),
                               jax_media.extract_audio(str(tmp_path / "a.wav")), atol=1e-6)


def test_array_reader_batches():
    frames = np.random.default_rng(12).integers(0, 255, (11, 8, 6, 3), dtype=np.uint8)
    reader = media.ArrayReader(frames, fps=25)
    got = list(reader.batches(4))
    assert [n for _, n in got] == [4, 4, 3]
    assert (reader.meta.width, reader.meta.height, reader.meta.total_frames) == (6, 8, 11)
    np.testing.assert_array_equal(got[-1][0][3], frames[-1])  # padded with the last frame


# --------------------------------------------------------------------------
# temporal plan and fusion
# --------------------------------------------------------------------------


@pytest.mark.parametrize("step", [1, 2, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_temporal_plan_equals_jax(step, seed):
    present = np.random.default_rng(seed).random(60) > 0.3
    got = visual.build_temporal_plan(present, step)
    want = jax_visual.build_temporal_plan(present, step)
    for name in ("present_index", "step_frames", "window_idx", "stat_src", "dyn_src"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("ce_weights_type", [False, True])
@pytest.mark.parametrize("ce_mask", [False, True])
@pytest.mark.parametrize("use_weights", [False, True])
def test_fused_compound_decision_equals_jax(ce_weights_type, ce_mask, use_weights):
    rng = np.random.default_rng(13)
    t = 200
    stat = rng.dirichlet(np.ones(7), t).astype(np.float32)
    dyn, aud = (rng.normal(size=(t, 7)).astype(np.float32) * 2 for _ in range(2))
    w1 = np.asarray(rng.random((3, 7)), np.float32)
    w2 = np.asarray([1.0, 0.5, 2.0], np.float32)
    kw = dict(ce_weights_type=ce_weights_type, ce_mask=ce_mask, use_weights=use_weights)
    want = jax_fusion.fused_compound_decision(*(jnp.asarray(a) for a in (stat, dyn, aud, w1, w2)),
                                              **kw)
    got = fusion.fused_compound_decision(*(torch.from_numpy(a) for a in (stat, dyn, aud, w1, w2)),
                                         **kw)
    av_prob = np.asarray(want["av_prob"])
    np.testing.assert_allclose(got["av_prob"].numpy(), av_prob, atol=1e-6, rtol=1e-5)
    top2 = np.sort(av_prob, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    decided = ~((gap > 0) & (gap <= 1e-4))  # f32 rounding may pick either
    for key in ("av", "vs", "vd", "a"):
        np.testing.assert_array_equal(got[key].numpy()[decided],
                                      np.asarray(want[key])[decided], err_msg=key)


def test_align_audio_and_decide_equal_jax(tmp_path):
    rng = np.random.default_rng(14)
    wins = jax_audio_stage.make_windows(np.zeros(40000, np.float32), AudioConfig(), 25)
    wl = rng.normal(size=(len(wins.spans), 8)).astype(np.float32)
    for t in (30, 80):
        np.testing.assert_array_equal(
            compound.align_audio_to_frames(wl, wins.frame_ids, wins.window_of_row, t),
            jax_compound.align_audio_to_frames(wl, wins.frame_ids, wins.window_of_row, t))
    stat = rng.dirichlet(np.ones(7), 40).astype(np.float32)
    dyn = rng.normal(size=(40, 7)).astype(np.float32)
    aud = rng.normal(size=(40, 8)).astype(np.float32)
    got = compound.decide(stat, dyn, aud, "clip", FusionConfig())
    want = jax_compound.decide(stat, dyn, aud, "clip", FusionConfig())
    assert got.image_locations == want.image_locations
    np.testing.assert_allclose(got.av_prob, want.av_prob, atol=1e-6, rtol=1e-5)
    compound.save_compound_txt(str(tmp_path / "a.txt"), got.image_locations, want.av)
    jax_compound.save_compound_txt(str(tmp_path / "b.txt"), want.image_locations, want.av)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


# --- the port's own copies of jax-free modules, pinned against the originals

COPIED_CONFIGS = ["DetectorConfig", "VisualConfig", "AudioConfig", "FusionConfig", "MeshConfig",
                  "PipelineConfig", "OptimConfig", "TrainConfig"]


@pytest.mark.parametrize("name", COPIED_CONFIGS)
def test_config_copy_equals_original(name):
    """Same field names, types and defaults, so that one side's values can be
    handed to the other."""
    import dataclasses

    from avcer_tpu.core import config as jax_config
    from avcer_tpu_torch.core import config as port_config

    want, got = getattr(jax_config, name), getattr(port_config, name)
    assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
        [(f.name, f.type) for f in dataclasses.fields(want)]
    assert port_config._asdict(got()) == jax_config._asdict(want())
    if name in ("PipelineConfig", "TrainConfig"):
        assert got().to_json() == want().to_json()
    if name == "PipelineConfig":
        values = jax_config._asdict(want(save_plot=False, weights_dir="w"))
        rebuilt = got(**{k: getattr(port_config, type(getattr(want(), k)).__name__)(**v)
                         if isinstance(v, dict) else v for k, v in values.items()})
        assert port_config._asdict(rebuilt) == values
        with pytest.raises(ValueError):
            got(visual=port_config.VisualConfig(cnn_stride=-1))


def test_registry_copy_equals_original():
    from avcer_tpu.core import registry as want
    from avcer_tpu_torch.core import registry as got

    def public(mod):
        return sorted(n for n in vars(mod) if not n.startswith("_") and n not in ("np", "annotations"))

    assert public(got) == public(want)
    checked = 0
    for name in public(want):
        a, b = getattr(want, name), getattr(got, name)
        if callable(a):
            continue
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
        checked += 1
    assert checked >= 15
    for fps in (5, 12, 24, 25, 30, 50, 60):
        assert got.dynamic_step(fps) == want.dynamic_step(fps)


@pytest.mark.parametrize("gap_frames", [1, 2])
def test_tracker_copy_gives_same_ids(gap_frames):
    """One seeded sequence of drifting, appearing and vanishing boxes through
    both trackers: equal ids on every frame."""
    from avcer_tpu.pipeline.tracker import IoUTracker as Want
    from avcer_tpu_torch.pipeline.tracker import IoUTracker as Got

    rng = np.random.default_rng(21)
    want = Want(iou_threshold=0.4, minimum_face_size=10.0, gap_frames=gap_frames)
    got = Got(iou_threshold=0.4, minimum_face_size=10.0, gap_frames=gap_frames)
    centres = rng.uniform(50, 250, (5, 2))
    sizes = rng.uniform(8, 60, 5)
    seen = set()
    for t in range(60):
        centres += rng.normal(0, 6, centres.shape)
        alive = rng.random(5) > 0.2
        if t % 17 == 16:
            alive[:] = False  # an empty frame clears every tracklet
        boxes = np.array([[cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2, 0.9]
                          for (cx, cy), s in zip(centres[alive], sizes[alive])]).reshape(-1, 5)
        a, b = want(boxes.copy()), got(boxes.copy())
        assert a == b, t
        seen.update(i for i in b if i is not None)
    assert len(seen) > 5


def test_viz_copy_writes_the_plot(tmp_path):
    pytest.importorskip("matplotlib")
    from avcer_tpu_torch.utils import viz

    series = {"AV": np.arange(20) % 7, "A": np.zeros(20, np.int64)}
    out = tmp_path / "plot.jpg"
    assert viz.plot_compound_expression_prediction(series, save_path=str(out)) is None
    assert out.stat().st_size > 1000
