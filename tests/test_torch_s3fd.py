"""The port's S3FD detector and face-detection demo against the JAX package
on the CPU: the no-+1 greedy NMS (plain version of the NMS kernel K1), the
network in f32 with the same weights carried over by
``avcer_tpu_torch.core.convert.s3fd``, the priors, the detect stage's packed
rows, the release file, and ``cli.detect_demo`` with both methods."""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.core.config import DetectorConfig as JaxDetectorConfig
from avcer_tpu.models.s3fd import S3FDNet as JaxS3FDNet
from avcer_tpu.models.s3fd import s3fd_priors as jax_s3fd_priors
from avcer_tpu.ops import nms as jax_nms
from avcer_tpu.pipeline.detect_s3fd import S3FDStage as JaxS3FDStage

from avcer_tpu_torch.core import checkpoint, convert
from avcer_tpu_torch.core.config import DetectorConfig
from avcer_tpu_torch.models.s3fd import S3FDNet, s3fd_priors
from avcer_tpu_torch.ops import nms
from avcer_tpu_torch.ops.cuda import nms_kernel
from avcer_tpu_torch.pipeline.detect_s3fd import S3FDStage

torch.set_num_threads(2)

#: seeded weights score no anchor of a noise frame above the served 0.8
#: (the largest score is about 0.66); at 0.5 the NMS has valid candidates to
#: suppress
THRESHOLD = 0.5


def nms_boxes(seed: int, b: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded boxes, with rows that only the +1 convention makes overlap:
    boxes that touch along an edge, zero-width and zero-area boxes, and
    exact duplicates of both."""
    rng = np.random.default_rng(seed)
    cx, cy = (rng.uniform(0, 100, (b, k)).astype(np.float32) for _ in range(2))
    w, h = (rng.uniform(2, 40, (b, k)).astype(np.float32) for _ in range(2))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)
    boxes[:, 0] = [200, 200, 210, 210]
    boxes[:, 1] = [210, 200, 220, 210]  # touches row 0 along x = 210
    boxes[:, 2] = [200, 210, 210, 220]  # touches row 0 along y = 210
    boxes[:, 3] = [230, 230, 230, 240]  # zero width
    boxes[:, 4] = [230, 230, 230, 240]  # its duplicate: IoU 0 / 0 without +1
    boxes[:, 5] = [250, 250, 250, 250]  # a point
    boxes[:, 6] = boxes[:, 7]  # a duplicate of a random box
    valid = rng.random((b, k)) > 0.2
    valid[:, :8] = True
    return boxes, valid


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("seed,b,k", [(0, 4, 64), (1, 2, 16), (2, 3, 9)])
def test_nms_mask_plus_one_equals_jax(seed, b, k, plus_one):
    boxes, valid = nms_boxes(seed, b, k)
    want = np.asarray(jax_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(valid), 0.3,
                                       plus_one=plus_one))
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = nms.nms_mask(bt, vt, 0.3, plus_one=plus_one).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper of K1 takes its plain version on CPU tensors, mode and all
    np.testing.assert_array_equal(nms_kernel.nms_mask(bt, vt, 0.3, plus_one=plus_one).numpy(),
                                  want)
    if not plus_one:
        # the edge-touching rows survive without the +1 and not with it
        assert got[:, 1].all() and got[:, 2].all()


def test_iou_without_plus_one_equals_jax():
    boxes, _ = nms_boxes(3, 2, 12)
    want = np.asarray(jax_nms.iou_matrix_legacy(jnp.asarray(boxes), plus_one=False))
    got = nms.iou_matrix_legacy(torch.from_numpy(boxes), plus_one=False).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where both are degenerate, on both sides


def randomize_biases(variables, seed: int):
    """Random conv biases (the init leaves them at zero), so that every
    converted leaf shows in the outputs."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                ((rng.normal(size=v.shape) * 0.05).astype(np.float32) if k == "bias" else v)
                for k, v in node.items()}

    return {kind: walk(tree) for kind, tree in variables.items()}


@pytest.fixture(scope="module")
def s3fd_pair():
    variables = randomize_biases(init_variables(
        JaxS3FDNet(dtype=jnp.float32), (jnp.zeros((1, 64, 64, 3), jnp.float32),), seed=3), 3)
    model = S3FDNet()
    model.load_state_dict(convert.s3fd(variables), strict=True)
    return variables, model.eval()


def test_s3fd_matches_jax(s3fd_pair):
    """f32 on both sides at a 96 x 160 input (13 conv layers of sums in
    another order: atol 1e-4 on the regressions, 1e-5 on the probabilities)."""
    variables, model = s3fd_pair
    rng = np.random.default_rng(0)
    x = rng.uniform(-120, 150, (2, 96, 160, 3)).astype(np.float32)
    want_loc, want_conf = jax.jit(JaxS3FDNet(dtype=jnp.float32).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        loc, conf = model(torch.from_numpy(x))
    assert loc.shape == want_loc.shape == (2, 1283, 4) and conf.shape == want_conf.shape
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_conf), atol=1e-5, rtol=1e-5)


def test_s3fd_state_dict_names(s3fd_pair):
    _, model = s3fd_pair
    names = set(model.state_dict())
    assert {"vgg.30.weight", "vgg.32.bias", "L2Norm3_3.weight", "extras.3.weight",
            "loc.5.bias", "conf.0.weight"} <= names
    assert model.conf[0].weight.shape[0] == 4 and model.conf[1].weight.shape[0] == 2


@pytest.mark.parametrize("hw", [(96, 160), (100, 130), (640, 360), (17, 33)])
def test_s3fd_priors_equal_jax(hw):
    np.testing.assert_array_equal(s3fd_priors(hw), jax_s3fd_priors(hw))


def test_s3fd_stage_packed_rows_match_jax(s3fd_pair):
    """The detect stage at batch 2: decode, top-64, the no-+1 NMS at 0.3,
    packed [B, 64, 16]. Boxes within 2e-3 px (f32 conv sums in another order,
    times the image scale), scores within 1e-5, keep masks and zero
    landmark slots equal."""
    variables, model = s3fd_pair
    frames = np.random.default_rng(1).integers(0, 255, (2, 96, 160, 3), dtype=np.uint8)
    jcfg = JaxDetectorConfig(long_side=160, batch_size=2, transfer_format="bgr",
                             threshold=THRESHOLD)
    jstage = JaxS3FDStage(jcfg, variables, dtype=jnp.float32)
    want = np.asarray(jstage._jit_forward(jstage.variables, jnp.asarray(frames))[0])
    cfg = DetectorConfig(long_side=160, batch_size=2, transfer_format="bgr",
                         threshold=THRESHOLD)
    stage = S3FDStage(cfg, model, device="cpu")
    before = nms_kernel.nms_mask.launches
    got = stage.forward(torch.from_numpy(frames)).numpy()
    assert nms_kernel.nms_mask.launches == before  # the CPU takes the plain version
    assert got.shape == want.shape == (2, 64, 16)
    keep = want[..., 5] > 0.5
    assert 0 < keep.sum() < (want[..., 4] > THRESHOLD).sum()  # NMS suppressed some
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., 4], want[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=2e-3, rtol=0)
    assert (got[..., 6:] == 0).all()


@pytest.mark.parametrize("kw,match", [(dict(stride=2), "stride"),
                                      (dict(quant="int8"), "quantized")])
def test_s3fd_stage_refusals(s3fd_pair, kw, match):
    cfg = DetectorConfig(transfer_format="bgr", **kw)
    with pytest.raises(ValueError, match=match):
        S3FDStage(cfg, s3fd_pair[1], device="cpu")


def test_s3fd_release_file_loads_strictly(s3fd_pair, tmp_path, caplog):
    """A state dict saved as ``s3fd_weights.pth`` with the ``module.`` prefix
    and a key the JAX converter leaves unread: resolved, mapped (the extra key
    dropped with a log line) and loaded strictly, equal to the converted
    weights; a missing key still fails the strict load."""
    variables, model = s3fd_pair
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.vgg.31.weight"] = torch.zeros(1)  # a ReLU slot: never a conv
    torch.save(sd, tmp_path / checkpoint.TORCH_FILES["s3fd"])
    loaded = checkpoint.resolve(str(tmp_path), "s3fd")
    with caplog.at_level(logging.INFO, logger="avcer_tpu_torch"):
        mapped = convert.release_state_dict("s3fd", loaded)
    assert "vgg.31.weight" in caplog.text
    fresh = S3FDNet()
    fresh.load_state_dict(mapped, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    del mapped["L2Norm4_3.weight"]
    with pytest.raises(RuntimeError, match="L2Norm4_3"):
        S3FDNet().load_state_dict(mapped, strict=True)


def write_clip(path: str, frames: int = 3) -> None:
    import cv2

    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (96, 64))
    for _ in range(frames):
        vw.write(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8))
    vw.release()


@pytest.mark.parametrize("argv", [["--method", "s3fd", "--threshold", str(THRESHOLD)],
                                  ["--method", "retinaface"],
                                  ["--method", "retinaface", "--benchmark", "mobilenet0.25"]])
def test_detect_demo_runs_on_cpu(tmp_path, capsys, argv):
    from avcer_tpu_torch.cli import detect_demo

    clip = str(tmp_path / "clip.avi")
    write_clip(clip)
    out = str(tmp_path / "annotated.avi")
    rc = detect_demo.main(["--input", clip, "--weights_dir", str(tmp_path / "weights"),
                           "--long_side", "96", "--output", out, "--device", "cpu"] + argv)
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("3 frames, faces on ") and lines[0].endswith(" fps")
    assert os.path.getsize(out) > 0


def test_detect_demo_defaults_to_cuda(tmp_path):
    from avcer_tpu_torch.cli import detect_demo

    if torch.cuda.is_available():
        pytest.skip("the refusal is what a machine without CUDA shows")
    clip = str(tmp_path / "clip.avi")
    write_clip(clip, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        detect_demo.main(["--input", clip, "--weights_dir", str(tmp_path)])
