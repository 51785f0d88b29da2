"""The I420 wire format of the port against the JAX package on the CPU: the
host conversion, the device rebuild's plain version, the detect stage's
``prepare_wire`` / ``dispatch_wire`` (float32 and int8, whose first-batch
calibration reads the rebuilt frames), S3FD on the wire, and the slice as a
whole: ``Pipeline.run`` on the JAX package's default ``transfer_format``.

The JAX package rebuilds BGR in XLA, which need not round a plain f32
evaluation of its formula the same way: the plain version is held to it
within 1 on at most 1e-3 of the values (the CUDA kernel must equal the plain
version exactly, tests/test_torch_cuda.py)."""

import threading

import numpy as np
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
from avcer_tpu.ops import image as jax_image
from avcer_tpu.pipeline import media as jax_media
from avcer_tpu.pipeline.detect import DetectStage as JaxDetectStage
from avcer_tpu.pipeline.detect_s3fd import S3FDStage as JaxS3FDStage
from avcer_tpu.pipeline.runner import Pipeline as JaxPipeline

from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.ops import image
from avcer_tpu_torch.ops.cuda import image_kernel
from avcer_tpu_torch.pipeline.builder import build_pipeline
from avcer_tpu_torch.pipeline.detect import DetectStage
from avcer_tpu_torch.pipeline.detect_s3fd import S3FDStage

from test_torch_int8 import numpy_tree
from test_torch_models import TINY_W2V2, port, randomize_stats
from test_torch_s3fd import THRESHOLD, s3fd_pair  # noqa: F401 - a fixture

torch.set_num_threads(2)

#: the rebuild's bound against XLA: within 1, on at most this share of values
REBUILD_SHARE = 1e-3


def seeded_frames(seed: int, b: int, h: int, w: int) -> np.ndarray:
    """A horizontal and vertical gradient plus seeded noise of +-20: smooth
    enough that the 4:2:0 subsampling matters, noisy enough to reach every
    rounding."""
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 60, h)[:, None, None]
    return np.clip(base[None] + rng.integers(-20, 21, (b, h, w, 3)), 0, 255).astype(np.uint8)


def assert_rebuild_close(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= REBUILD_SHARE, (diff > 0).mean()


# ---------------------------------------------------------------- the ops

@pytest.mark.parametrize("b,h,w", [(4, 360, 640), (2, 6, 10), (3, 48, 64), (2, 252, 448)])
def test_bgr_batch_to_i420_equals_jax(b, h, w):
    frames = seeded_frames(b + h, b, h, w)
    got = image.bgr_batch_to_i420(frames)
    assert got.shape == (b, h * 3 // 2, w)
    np.testing.assert_array_equal(got, jax_image.bgr_batch_to_i420(frames))


@pytest.mark.parametrize("b,h,w", [(4, 360, 640), (2, 6, 10), (3, 48, 64), (2, 252, 448),
                                   (1, 2, 2)])
def test_i420_to_bgr_plain_matches_jax(b, h, w):
    """The plain rebuild against ``i420_to_bgr_device``. At h = 6, w = 10 the
    U plane (3 x 5 = 15 bytes) ends in the middle of the second chroma row of
    10: read flat, as the JAX function reads it."""
    wire = image.bgr_batch_to_i420(seeded_frames(h * w, b, h, w))
    want = np.asarray(jax_image.i420_to_bgr_device(jnp.asarray(wire), h, w))
    before = image_kernel.i420_to_bgr.launches
    got = image_kernel.i420_to_bgr(torch.from_numpy(wire), h, w)  # the CPU: plain
    assert image_kernel.i420_to_bgr.launches == before
    np.testing.assert_array_equal(got.numpy(), image.i420_to_bgr_plain(
        torch.from_numpy(wire), h, w).numpy())
    assert_rebuild_close(got.numpy(), want)


def test_i420_to_bgr_plain_rounds_half_to_even_and_clamps():
    """A Y plane of 16 and chroma of 128 give exactly 0; Y = 255 with U = 255
    overflows blue and clamps to 255; Y = 0 clamps to 0."""
    wire = np.zeros((1, 3, 2), np.uint8)
    wire[0, :2] = [[16, 255], [0, 16]]
    wire[0, 2] = [128, 128]
    got = image.i420_to_bgr_plain(torch.from_numpy(wire), 2, 2).numpy()[0]
    want = np.asarray(jax_image.i420_to_bgr_device(jnp.asarray(wire), 2, 2))[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [0, 0, 0])
    np.testing.assert_array_equal(got[0, 1], [255, 255, 255])
    np.testing.assert_array_equal(got[1, 0], [0, 0, 0])


# ------------------------------------------------------------ the detect stage

def detector_pair(quant: bool):
    jm = JaxRetinaFace(backbone="resnet50", dtype=jnp.float32, quant=quant)
    variables = numpy_tree(init_variables(jm, (jnp.zeros((1, 64, 64, 3)),), seed=5))
    model = port(RetinaFace(quant=quant), convert.retinaface(variables))
    return variables, model.eval().requires_grad_(False)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_detect_stage_i420_matches_jax(quant):
    """Both stages on the JAX default (I420) at the 64 bucket, from 72 x 96
    native frames (cv2 letterboxes them to 48 x 64 on both sides), exact and
    in int8. The wires are equal byte for byte and the rebuilt frames within
    the rebuild's bound. The scores are held within the bounds of the ``bgr``
    comparisons (tests/test_torch_pipeline.py and
    tests/test_torch_int8_pipeline.py). Exact, the keep masks are equal, and
    the boxes and landmarks are held at those bounds to the port's forward of
    the JAX package's rebuilt frames: the two rebuilds differ by 1 on 3 of
    these 27,648 values, and the seeded init's box decode takes an
    exponential of activations in the hundreds (boxes of 1e5 px), which turns
    such a pixel into a move of a few px. ``dispatch`` and ``prepare_wire`` +
    ``dispatch_wire`` give the same result; in int8 the first batch's
    calibration forward reads the rebuilt frames on both sides, and the
    refined scales agree within 2 % (a value flipped upstream moves a later
    conv's input max by a quantisation step)."""
    variables, model = detector_pair(quant == "int8")
    cfg = DetectorConfig(long_side=64, batch_size=2, threshold=0.3, dtype="float32", quant=quant)
    assert cfg.transfer_format == "i420"
    frames = seeded_frames(6, 2, 72, 96)
    jax_stage = JaxDetectStage(cfg, variables, dtype=jnp.float32)
    stage = DetectStage(cfg, model, device="cpu")
    jwire, jscale = jax_stage.prepare_wire(frames)
    wire, scale = stage.prepare_wire(frames)
    assert wire.shape == (2, 72, 64) and scale == jscale
    np.testing.assert_array_equal(wire, jwire)
    jpacked, _, jframes = jax_stage.dispatch_wire(jwire, jscale)
    want = JaxDetectStage.unpack(np.asarray(jpacked, np.float32), jscale)
    packed, _, frames_dev = stage.dispatch_wire(wire, scale)
    got = stage.unpack(packed.numpy(), scale)
    assert_rebuild_close(frames_dev.numpy(), np.asarray(jframes))
    assert 16 < (want.scores > 0.3).sum(axis=1).min()
    if quant == "int8":
        assert stage.calibration_forwards == 2 and stage._real_calibrated
        want_s = convert.act_scales("retinaface", {**variables, "act_scales": numpy_tree(
            jax_stage.variables["act_scales"])})
        got_s = layers.act_scales(model)
        assert set(got_s) == set(want_s)
        for k in want_s:
            np.testing.assert_allclose(float(got_s[k]), float(want_s[k]), rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4, rtol=1e-3)
    if quant == "none":
        np.testing.assert_array_equal(got.keep, want.keep)
        same = stage.unpack(stage.forward(torch.from_numpy(np.array(jframes))).numpy(), scale)
        np.testing.assert_allclose(same.boxes, want.boxes, atol=1e-2, rtol=1e-3)
        np.testing.assert_allclose(same.landmarks, want.landmarks, atol=1e-2, rtol=1e-3)
        np.testing.assert_array_equal(same.keep, want.keep)
    again, scale2, frames2 = stage.dispatch(frames)  # prepare_wire + dispatch_wire
    assert scale2 == scale
    np.testing.assert_array_equal(frames2.numpy(), frames_dev.numpy())
    np.testing.assert_array_equal(again.numpy(), packed.numpy())


def test_detect_stage_bgr_route_unchanged():
    """``"bgr"`` keeps the native upload and the device letterbox: the wire
    is the native frames, and ``dispatch`` equals a forward of
    ``letterbox_device``'s frames; ``prepare_batch`` follows the wire's
    letterbox (host cv2 under I420); an unknown format is refused."""
    _, model = detector_pair(False)
    cfg = DetectorConfig(long_side=64, batch_size=2, transfer_format="bgr", threshold=0.3,
                         dtype="float32")
    stage = DetectStage(cfg, model, device="cpu")
    frames = seeded_frames(7, 2, 72, 96)
    wire, scale = stage.prepare_wire(frames)
    assert wire is frames and scale == 64 / 96
    lb, lb_scale = stage.letterbox_device(frames)
    packed, _, frames_dev = stage.dispatch(frames)
    np.testing.assert_array_equal(frames_dev.numpy(), lb.numpy())
    np.testing.assert_array_equal(packed.numpy(), stage.forward(lb).numpy())
    assert lb_scale == scale
    np.testing.assert_array_equal(stage.prepare_batch(frames)[0].numpy(), lb.numpy())
    i420 = DetectStage(DetectorConfig(long_side=64, dtype="float32"), model, device="cpu")
    np.testing.assert_array_equal(i420.prepare_batch(frames)[0].numpy(),
                                  i420.letterbox_host(frames)[0])
    with pytest.raises(ValueError, match="transfer_format"):
        DetectStage(DetectorConfig(transfer_format="nv12"), model, device="cpu")


def test_s3fd_stage_i420_matches_jax(s3fd_pair):  # noqa: F811 - the fixture
    """S3FD on the JAX default wire, as JAX ``detect_s3fd.py`` takes it, at the
    160 bucket from 120 x 200 frames: the rebuilt frames within the rebuild's
    bound and the keep masks equal; the port's forward of the JAX package's
    rebuilt frames within the bounds of the ``bgr`` comparison
    (tests/test_torch_s3fd.py) of the JAX rows (a pixel 1 apart moves a score
    by some 1e-5, the bound itself)."""
    variables, model = s3fd_pair
    frames = seeded_frames(1, 2, 120, 200)
    jstage = JaxS3FDStage(DetectorConfig(long_side=160, batch_size=2, threshold=THRESHOLD),
                          variables, dtype=jnp.float32)
    jpacked, jscale, jframes = jstage.dispatch(frames)
    cfg = DetectorConfig(long_side=160, batch_size=2, threshold=THRESHOLD)
    stage = S3FDStage(cfg, model, device="cpu")
    packed, scale, frames_dev = stage.dispatch(frames)
    got = packed.numpy()
    assert scale == jscale and frames_dev.shape == (2, 96, 160, 3)
    assert_rebuild_close(frames_dev.numpy(), np.asarray(jframes))
    np.testing.assert_array_equal(got[..., 5], np.asarray(jpacked)[..., 5])
    want = np.asarray(jpacked)
    keep = want[..., 5] > 0.5
    assert 0 < keep.sum() < (want[..., 4] > THRESHOLD).sum()
    same = stage.forward(torch.from_numpy(np.array(jframes))).numpy()
    np.testing.assert_array_equal(same[..., 5], want[..., 5])
    np.testing.assert_allclose(same[..., 4], want[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(same[..., :4], want[..., :4], atol=2e-3, rtol=0)


# ---------------------------------------------------------- the slice as a whole

H, W, N_FRAMES, FPS = 72, 96, 20, 25
#: the one face, in the 48 x 64 bucket's pixels
FACE = (16.0, 12.0, 48.0, 36.0)


def face_rows(b: int) -> np.ndarray:
    packed = np.zeros((b, 8, 16), np.float32)
    packed[:, 0, 0:4] = FACE
    packed[:, 0, 4] = 0.95
    packed[:, 0, 5] = 1.0
    return packed


class JaxWireStub(JaxDetectStage):
    """The JAX detect stage's wire path (``prepare_wire`` in the prefetch
    thread, ``dispatch_wire``, the rebuild in the jitted forward), with the
    network replaced by one fixed face a frame."""

    def __init__(self, cfg):
        self.cfg, self.mesh, self.variables = cfg, None, {}
        self._real_calibrated = True
        self._jit_forward = jax.jit(self._forward_impl)

    def _forward_impl(self, variables, wire):
        frames = jax_image.i420_to_bgr_device(wire, wire.shape[1] * 2 // 3, wire.shape[2])
        return jnp.asarray(face_rows(frames.shape[0])), frames


class PortWireStub(DetectStage):
    """The port's detect stage, the same way; records the threads that
    prepared a wire."""

    def __init__(self, cfg):
        super().__init__(cfg, torch.nn.Module(), device="cpu")
        self.prepared_on = set()

    def prepare_wire(self, frames):
        self.prepared_on.add(threading.current_thread() is threading.main_thread())
        return super().prepare_wire(frames)

    def forward(self, frames):
        return torch.from_numpy(face_rows(frames.shape[0]))


@pytest.fixture(scope="module")
def wire_runs(tmp_path_factory):
    import cv2

    tmp = tmp_path_factory.mktemp("wire")
    video = str(tmp / "clip.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (W, H))
    for frame in seeded_frames(3, N_FRAMES, H, W):
        vw.write(frame)
    vw.release()
    wav = (np.random.default_rng(4).normal(size=int(1.2 * 16000)) * 0.1).astype(np.float32)
    jax_media.write_wav(str(tmp / "clip.wav"), wav, 16000)
    cfg = PipelineConfig(
        detector=DetectorConfig(batch_size=8, long_side=64, dtype="float32"),
        visual=VisualConfig(batch_size=16, dtype="float32"),
        audio=AudioConfig(batch_size=4, dtype="float32"),
        weights_dir=str(tmp / "no_weights"), save_plot=False)
    assert cfg.detector.transfer_format == PipelineConfig().detector.transfer_format == "i420"
    variables = {
        "emotion_resnet50": randomize_stats(init_variables(
            JaxEmotionResNet50(7), (jnp.zeros((1, 64, 64, 3)),), 1), 1),
        "temporal_lstm": init_variables(JaxTemporalLSTM(7), (jnp.zeros((1, 10, 512)),), 2),
        "expr_model": randomize_stats(init_variables(
            JaxExprModel("v3", 8, JaxW2V2Config(**TINY_W2V2)), (jnp.zeros((1, 17000)),), 3), 3),
    }
    jax_pipe = JaxPipeline(cfg, {}, variables["emotion_resnet50"], variables["temporal_lstm"],
                           variables["expr_model"], JaxW2V2Config(**TINY_W2V2))
    jax_pipe.detect = JaxWireStub(cfg.detector)
    want = jax_pipe.run(video, "")
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu",
                          jax_variables=variables)
    pipe.detect = PortWireStub(cfg.detector)
    got = pipe.run(video, "")
    return want, got, pipe.detect.prepared_on


def test_slice_on_the_i420_wire_matches_jax(wire_runs):
    """``Pipeline.run`` of both packages on the JAX default wire format: the
    host letterbox and I420 conversion, the device rebuild, the emotion CNN on
    crops of the rebuilt frames. The wire is prepared in the prefetch thread,
    never on the main one. Boxes are equal, the CNN's probabilities within
    the bound of the ``bgr`` slice test, and the compound decisions equal on
    every frame."""
    want, got, prepared_on = wire_runs
    assert prepared_on == {False}
    assert got.total_frames == want.total_frames == N_FRAMES
    np.testing.assert_array_equal(got.face_boxes, want.face_boxes)
    assert (got.face_boxes[:, 0] >= 0).all()
    np.testing.assert_allclose(got.stat_probs, want.stat_probs, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got.dyn_logits, want.dyn_logits, atol=1e-3, rtol=1e-2)
    np.testing.assert_allclose(got.compound.av_prob, want.compound.av_prob, atol=1e-4)
    for key in ("av", "vs", "vd", "a"):
        np.testing.assert_array_equal(getattr(got.compound, key), getattr(want.compound, key),
                                      err_msg=key)
