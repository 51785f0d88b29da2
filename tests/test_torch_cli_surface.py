"""The rest of ``cli.run``'s surface in the port against the JAX package on
the CPU: the audio heads V1 / V2 / V3 with 7 or 8 classes, Grad-CAM
(``--heatmaps``), the host-crop path (``--save_face_crops``) and the pipeline
built from release files. Two clips run on each side, with one stub detector
(two faces, one of which comes and goes, so the tracker makes several
tracklets):

- (a) ``save_face_crops``, ``heatmaps="static"``, audio V2 with 7 classes,
  every family loaded from a release directory of torch twins;
- (b) the device path, ``heatmaps="dynamic"``, audio V1 with 8 classes,
  weights handed in as JAX trees.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from avcer_tpu.core import checkpoint as jax_checkpoint
from avcer_tpu.core import config as jax_config
from avcer_tpu.core import convert as jax_convert
from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V2Config
from avcer_tpu.pipeline import media as jax_media
from avcer_tpu.pipeline.detect import DetectStage as JaxDetectStage
from avcer_tpu.pipeline.runner import Pipeline as JaxPipeline
from avcer_tpu.utils import gradcam as jax_gradcam
from avcer_tpu.utils import viz as jax_viz

from avcer_tpu_torch.core import config as port_config
from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.pipeline import media
from avcer_tpu_torch.pipeline.builder import build_pipeline
from avcer_tpu_torch.pipeline.detect import DetectStage
from avcer_tpu_torch.utils import gradcam, viz

from test_torch_models import randomize_stats
from test_torch_release import W2V2_LAYERS, write_release_dir

torch.set_num_threads(2)

TINY_W2V2 = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                 conv_dim=(16,) * 7)
H = W = 96
N_FRAMES, FPS = 30, 25
STEP = 5  # registry.dynamic_step(25): 6 step frames


def face_rows(t: np.ndarray) -> np.ndarray:
    """[len(t), 2, 5] boxes and scores of the stub's two faces on frames t:
    A drifts by fractions of a pixel (so the int cast matters) on every
    frame; B sits in a corner and is missing on every frame t % 7 == 3."""
    t = t.astype(np.float32)
    a = np.stack([24 + 0.31 * t, 20 + 0.47 * t, 70 + 0.29 * t, 74 + 0.23 * t,
                  np.full_like(t, 0.95)], -1)
    b = np.stack([np.full_like(t, 3.6), np.full_like(t, 4.2), np.full_like(t, 31.7),
                  np.full_like(t, 33.1), np.where(t % 7 == 3, 0.0, 0.9)], -1)
    return np.stack([a, b], 1)


class JaxTwoFaces:
    """Counts the frames it is handed (batches arrive in clip order, the
    last one padded) and reports the two faces of ``face_rows``."""

    def __init__(self):
        self.t = 0

    def dispatch(self, frames):
        n = frames.shape[0]
        rows = face_rows(np.arange(self.t, self.t + n))
        self.t += n
        packed = np.zeros((n, 8, 16), np.float32)
        packed[:, :2, :5] = rows
        packed[:, :2, 5] = rows[:, :, 4] > 0
        return packed, 1.0, jnp.asarray(frames)

    def unpack(self, packed_np, scale):
        return JaxDetectStage.unpack(packed_np, scale)


class PortTwoFaces(JaxTwoFaces):
    def dispatch(self, frames):
        packed, scale, _ = super().dispatch(frames)
        return torch.from_numpy(packed), scale, torch.from_numpy(frames)

    def unpack(self, packed_np, scale):
        return DetectStage.unpack(packed_np, scale)


def configs(weights_dir: str, **kw):
    """The same configuration in the JAX package's classes and the port's."""
    audio = kw.pop("audio")
    return [mod.PipelineConfig(
        detector=mod.DetectorConfig(batch_size=8, long_side=64, transfer_format="bgr",
                                    dtype="float32"),
        visual=mod.VisualConfig(batch_size=8, dtype="float32"),
        audio=mod.AudioConfig(batch_size=4, dtype="float32", **audio),
        weights_dir=weights_dir, save_plot=False, **kw) for mod in (jax_config, port_config)]


def record_gradcam(visual, log: list) -> None:
    inner = visual.gradcam

    def wrapped(crops, classes):
        masks = inner(crops, classes)
        log.append((np.array(crops), np.array(classes), np.array(masks)))
        return masks

    visual.gradcam = wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import cv2

    tmp = tmp_path_factory.mktemp("surface")
    rng = np.random.default_rng(0)
    video = str(tmp / "clip.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (W, H))
    for _ in range(N_FRAMES):
        vw.write(rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8))
    vw.release()
    jax_media.write_wav(str(tmp / "clip.wav"),
                        (rng.normal(size=int(1.5 * 16000)) * 0.1).astype(np.float32), 16000)
    out = {}

    # (a) the host-crop path from release files
    release = write_release_dir(tmp / "release")
    jcfg, pcfg = configs(release, save_face_crops=True, heatmaps="static",
                         audio=dict(head="v2", num_classes=7))
    jv = {fam: jax_checkpoint.resolve(release, fam, conv, None, (), cache=False, **kw)
          for fam, conv, kw in (
              ("emotion_resnet50", jax_convert.convert_emotion_resnet50, {}),
              ("temporal_lstm", jax_convert.convert_temporal_lstm, {}),
              ("expr_model_7cl", jax_convert.convert_expr_model,
               {"variant": "v2", "num_layers": W2V2_LAYERS}))}
    jpipe = JaxPipeline(jcfg, {}, jv["emotion_resnet50"], jv["temporal_lstm"],
                        jv["expr_model_7cl"], JaxW2V2Config(num_layers=W2V2_LAYERS))
    ppipe = build_pipeline(pcfg, Wav2Vec2Config(num_layers=W2V2_LAYERS), device="cpu")
    out["a"] = run_both(jpipe, ppipe, video, tmp, "a")

    # (b) the device path, weights as JAX trees: the visual ones converted
    # from the same twins (the JAX init's deep residual stack saturates the
    # softmax, and with it every Grad-CAM gradient)
    variables = {
        "emotion_resnet50": jax.tree.map(np.asarray, jv["emotion_resnet50"]),
        "temporal_lstm": jax.tree.map(np.asarray, jv["temporal_lstm"]),
        "expr_model": randomize_stats(init_variables(
            JaxExprModel("v1", 8, JaxW2V2Config(**TINY_W2V2)), (jnp.zeros((1, 17000)),), 3), 3),
    }
    jcfg, pcfg = configs(str(tmp / "no_weights"), heatmaps="dynamic",
                         audio=dict(head="v1", num_classes=8))
    jpipe = JaxPipeline(jcfg, {}, variables["emotion_resnet50"], variables["temporal_lstm"],
                        variables["expr_model"], JaxW2V2Config(**TINY_W2V2))
    ppipe = build_pipeline(pcfg, Wav2Vec2Config(**TINY_W2V2), device="cpu",
                           jax_variables=variables)
    out["b"] = run_both(jpipe, ppipe, video, tmp, "b")
    return out


def run_both(jpipe, ppipe, video, tmp, tag):
    sides = {}
    for side, pipe, stub in (("jax", jpipe, JaxTwoFaces()), ("port", ppipe, PortTwoFaces())):
        pipe.detect = stub
        cams: list = []
        record_gradcam(pipe.visual, cams)
        clip = pipe.run(video, str(tmp / f"{tag}_{side}"))
        sides[side] = dict(clip=clip, cams=cams, out=tmp / f"{tag}_{side}", pipe=pipe)
    return sides


def tree(root) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("run", ["a", "b"])
def test_output_trees_match_jax(runs, run):
    """Both runs write the same files as the JAX package: CSVs, compound txt,
    heatmaps of the 6 step frames and, in (a), every tracklet's crops; (a)'s
    7-class audio CSV under ``audio_mean_0.5/``."""
    jax_out, port_out = runs[run]["jax"]["out"], runs[run]["port"]["out"]
    files = tree(jax_out)
    assert files == tree(port_out)
    mode = "static" if run == "a" else "dynamic"
    heat = [f for f in files if f.startswith(f"clip/heatmaps_{mode}/")]
    assert heat == [f"clip/heatmaps_{mode}/{t:06d}.jpg" for t in range(0, N_FRAMES, STEP)]
    crops = [f for f in files if f.startswith("clip/") and "heatmaps" not in f]
    if run == "a":
        # A is tracklet 1 on all 30 frames; B is a new tracklet after each gap
        assert "audio_mean_0.5/audio__clip.csv" in files and "audio__clip.csv" not in files
        assert sum(f.startswith("clip/00/") for f in crops) == N_FRAMES
        assert len({os.path.dirname(f) for f in crops}) == 1 + len(range(3, N_FRAMES, 7)) + 1
        assert len(crops) == N_FRAMES + N_FRAMES - len(range(3, N_FRAMES, 7))
    else:
        assert "audio__clip.csv" in files and not crops


@pytest.mark.parametrize("run", ["a", "b"])
def test_csvs_match_jax(runs, run):
    """CSV values within tests/test_torch_pipeline.py's bounds (f32 on both
    sides); the audio CSV has the 7 or 8 columns of its head."""
    jax_out, port_out = runs[run]["jax"]["out"], runs[run]["port"]["out"]
    bounds = {"static": (1e-4, 1e-3), "dynamic": (1e-3, 1e-2), "audio": (5e-4, 1e-3)}
    for name in (f for f in tree(jax_out) if f.endswith(".csv")):
        a, b = pd.read_csv(jax_out / name), pd.read_csv(port_out / name)
        assert list(a.columns) == list(b.columns) and a.shape == b.shape
        kind = os.path.basename(name).split("__")[0]
        if kind == "audio":
            assert len(a.columns) == (7 if run == "a" else 8) + 1
            assert list(a["frames"]) == list(b["frames"])
            a, b = a.drop(columns="frames"), b.drop(columns="frames")
        atol, rtol = bounds[kind]
        np.testing.assert_allclose(b.to_numpy(np.float64), a.to_numpy(np.float64),
                                   atol=atol, rtol=rtol, err_msg=name)


def test_face_crop_jpgs_equal_jax(runs):
    """The host-crop path's jpgs: the two sides' int boxes agree on every
    crop here (the stub hands both the same detections), and then the files
    are equal byte for byte: 56 crops, 30 of face A and 26 of face B."""
    jax_out, port_out = runs["a"]["jax"]["out"], runs["a"]["port"]["out"]
    crops = [f for f in tree(jax_out) if f.startswith("clip/") and "heatmaps" not in f]
    assert len(crops) == 56
    for name in crops:
        assert (jax_out / name).read_bytes() == (port_out / name).read_bytes(), name


@pytest.mark.parametrize("run", ["a", "b"])
def test_gradcam_masks_match_jax(runs, run):
    """The heatmaps' Grad-CAM masks: the same crops (host crops in (a), the
    device path's step-frame fetch in (b)) and classes on both sides, masks
    [6, 7, 7] within 1e-3 of JAX's (f32; layer4's activations differ by
    summation order)."""
    jcams, pcams = runs[run]["jax"]["cams"], runs[run]["port"]["cams"]
    assert len(jcams) == len(pcams) == 1
    (jc, jk, jm), (pc, pk, pm) = jcams[0], pcams[0]
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pk, jk)
    assert pm.shape == jm.shape == (N_FRAMES // STEP, 7, 7)
    np.testing.assert_allclose(pm, jm, atol=1e-3)
    assert (pm.max(axis=(1, 2)) == 1).all()  # no mask is degenerate


def test_run_static_matches_jax(runs):
    """``VisualStage.run_static`` on host crops (one batch of 8 filled up
    from 5 crops), as the JAX package's, within the emotion CNN's bounds."""
    crops = np.random.default_rng(3).integers(0, 255, (5, 224, 224, 3), np.uint8)
    jp, jf = runs["a"]["jax"]["pipe"].visual.run_static(crops)
    pp, pf = runs["a"]["port"]["pipe"].visual.run_static(crops)
    np.testing.assert_allclose(pp, jp, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(pf, jf, atol=1e-3, rtol=1e-2)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
@pytest.mark.parametrize("classes", [7, 8])
def test_expr_model_matches_jax(variant, classes):
    """ExprModel V1 (the GRU) / V2 / V3 with 7 or 8 classes at a narrow
    wav2vec2, the same weights on both sides (core.convert), within
    test_model_parity.py's ExprModel bound."""
    jax_model = JaxExprModel(variant=variant, num_classes=classes,
                             wav2vec2_config=JaxW2V2Config(**TINY_W2V2))
    variables = randomize_stats(init_variables(jax_model, (jnp.zeros((1, 17000)),), seed=4), 4)
    model = ExprModel(variant, classes, Wav2Vec2Config(**TINY_W2V2))
    model.load_state_dict(convert.expr_model(variables), strict=True)
    x = np.random.default_rng(3).normal(size=(2, 17000)).astype(np.float32)
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (2, classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)


def test_gradcam_masks_function_matches_jax():
    """``utils.gradcam.gradcam_masks`` against the JAX package's on layer4
    activations [4, 7, 7, 64] (NHWC there, NCHW here) and a 64 -> 32 -> 7
    head, f32, within 1e-5."""
    rng = np.random.default_rng(0)
    act4 = np.maximum(rng.normal(size=(4, 7, 7, 64)), 0).astype(np.float32)
    fc1, fc2 = torch.nn.Linear(64, 32), torch.nn.Linear(32, 7)
    classes = np.array([0, 3, 6, 2])
    params = {name: {"kernel": jnp.asarray(m.weight.detach().numpy().T),
                     "bias": jnp.asarray(m.bias.detach().numpy())}
              for name, m in (("fc1", fc1), ("fc2", fc2))}
    want = np.asarray(jax_gradcam.gradcam_masks(jnp.asarray(act4), params, jnp.asarray(classes)))
    with torch.inference_mode():  # as the pipeline holds its activations
        a = torch.from_numpy(act4).permute(0, 3, 1, 2)
        got = gradcam.gradcam_masks(a, fc1, fc2, classes).numpy()
    assert got.shape == (4, 7, 7)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_host_helpers_pinned_to_jax():
    """The copies ``media.resize_nearest_np``, ``viz.show_cam_on_image`` and
    ``gradcam.render_heatmap`` give their originals' outputs exactly."""
    rng = np.random.default_rng(1)
    for h, w in ((48, 48), (37, 91), (300, 17)):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        np.testing.assert_array_equal(media.resize_nearest_np(img, (224, 224)),
                                      jax_media.resize_nearest_np(img, (224, 224)))
    img = rng.random((32, 32, 3)).astype(np.float32)
    mask = rng.random((32, 32)).astype(np.float32)
    for use_rgb, weight in ((False, 0.5), (True, 0.8)):
        np.testing.assert_array_equal(
            viz.show_cam_on_image(img, mask, use_rgb=use_rgb, image_weight=weight),
            jax_viz.show_cam_on_image(img, mask, use_rgb=use_rgb, image_weight=weight))
    face = rng.integers(0, 255, (48, 40, 3), np.uint8)
    np.testing.assert_array_equal(gradcam.render_heatmap(mask[:7, :7], face),
                                  jax_gradcam.render_heatmap(mask[:7, :7], face))
