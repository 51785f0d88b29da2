"""The mobilenet0.25 RetinaFace of avcer_tpu_torch against the JAX package's
on the CPU, f32 on both sides, the same weights (and int8 activation scales)
carried across with ``core.convert``: unfused, with ``fused_ssh`` and with
``fused_ssh + fused_fpn`` (the JAX side's Pallas kernel in interpret mode, the
port's plain version of its CUDA kernel), exact and int8; the state-dict round
trip from a reference torch twin; the detect stage and the builder with the
mobilenet model.

At 64 channels the FPN and the SSH modules use leaky ReLU 0.1, so these are
the tests of ``fused_ssh_heads`` with ``leaky = 0.1`` inside a model."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from avcer_tpu.core import convert as jax_convert
from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.core.config import DetectorConfig
from avcer_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from avcer_tpu.pipeline.detect import DetectStage as JaxDetectStage

from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models.retinaface import ConvDW, MobileNetV1Body, RetinaFace
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.ops.cuda import fused_ssh_kernel
from avcer_tpu_torch.pipeline.builder import build_pipeline
from avcer_tpu_torch.pipeline.detect import DetectStage

import torch_twins as twins
from test_torch_int8 import calibrated, numpy_tree, port_int8, rel_max
from test_torch_models import TINY_W2V2, port, randomize_stats

torch.set_num_threads(2)

MNET = "mobilenet0.25"
SWITCHES = [{}, dict(fused_ssh=True), dict(fused_ssh=True, fused_fpn=True)]
SWITCH_IDS = ["unfused", "fused_ssh", "fused_ssh_fpn"]
INT8_INPUT_SEED = 41


def spy_leaky(monkeypatch) -> list:
    """Records ``(leaky, int8?, with the FPN?)`` of every ``fused_ssh_heads``
    call that reaches the plain version (the CPU's route)."""
    calls = []
    inner = fused_ssh_kernel.fused_ssh_heads_plain

    def plain(x, conv_folded, head_folded, leaky=0.0, fpn_lat=None, *a, **k):
        act_s = k.get("act_s", a[4] if len(a) > 4 else None)
        calls.append((leaky, act_s is not None, fpn_lat is not None))
        return inner(x, conv_folded, head_folded, leaky, fpn_lat, *a, **k)

    monkeypatch.setattr(fused_ssh_kernel, "fused_ssh_heads_plain", plain)
    return calls


@pytest.fixture(scope="module")
def mobilenet_pair():
    jm = JaxRetinaFace(backbone=MNET)
    variables = randomize_stats(init_variables(jm, (jnp.zeros((1, 64, 64, 3)),), seed=11), 11)
    x = (np.random.default_rng(12).normal(size=(2, 72, 56, 3)) * 20).astype(np.float32)
    return variables, x, jm.apply(variables, jnp.asarray(x))


@pytest.mark.parametrize("switches", SWITCHES, ids=SWITCH_IDS)
def test_mobilenet_retinaface_matches_jax(mobilenet_pair, switches, monkeypatch):
    """f32, a 72 x 56 input (odd feature sizes at stride 16 and 32). Against
    the JAX model under the same switches: test_model_parity.py's RetinaFace
    bounds (conv sums in another order). Against the unfused JAX model:
    test_pallas_kernels.py's bound for its fused kernel (atol 2e-5, rtol 1e-4
    with ``fused_ssh``; 1e-4 of the largest value with the FPN fused too)."""
    variables, x, want_unfused = mobilenet_pair
    calls = spy_leaky(monkeypatch)
    model = port(RetinaFace(backbone=MNET, **switches), convert.retinaface(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = want_unfused if not switches else JaxRetinaFace(backbone=MNET, **switches).apply(
        variables, jnp.asarray(x))
    for g, w, atol in zip(got, want, (1e-3, 1e-4, 1e-3)):
        assert g.shape == w.shape == (2, g.shape[1], w.shape[2])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-2)
    for g, u in zip(got, want_unfused):
        if "fused_fpn" in switches:
            assert rel_max(g.numpy(), u) < 1e-4
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(u), atol=2e-5, rtol=1e-4)
    # three scales a forward, each with the 64-channel model's leaky slope
    assert calls == ([(0.1, False, "fused_fpn" in switches)] * 3 if switches else [])


@pytest.fixture(scope="module")
def mobilenet_int8():
    jm = JaxRetinaFace(backbone=MNET, dtype=jnp.float32, quant=True)
    variables = randomize_stats(init_variables(jm, (jnp.zeros((1, 64, 64, 3)),), seed=13), 13)
    # an input that flips no quantised value between the two sides (see
    # tests/test_torch_int8.py retinaface_int8)
    x = (np.random.default_rng(INT8_INPUT_SEED).normal(size=(1, 72, 56, 3)) * 20).astype(
        np.float32)
    variables = calibrated(jm, variables, x)
    return variables, x, jm.apply(variables, jnp.asarray(x))


@pytest.mark.parametrize("switches", SWITCHES, ids=SWITCH_IDS)
def test_mobilenet_retinaface_int8_matches_jax(mobilenet_int8, switches, monkeypatch):
    """The int8 mobilenet detector with the JAX tree's ``act_scales`` carried
    across: the port against the JAX model under the same switches and against
    the unfused JAX int8 model, within the JAX package's bound for fused
    against unfused int8 (1e-4 of the largest value). The pointwise convs are
    8 to 256 wide: ``layers.int_mm`` pads K and N to multiples of 8."""
    variables, x, want_unfused = mobilenet_int8
    calls = spy_leaky(monkeypatch)
    model = port_int8(RetinaFace(backbone=MNET, quant=True, **switches), "retinaface", variables)
    got = model(torch.from_numpy(x))
    want = want_unfused if not switches else JaxRetinaFace(
        backbone=MNET, dtype=jnp.float32, quant=True, **switches).apply(variables, jnp.asarray(x))
    for g, w, u in zip(got, want, want_unfused):
        assert g.shape == w.shape
        assert rel_max(g.numpy(), w) < 1e-4
        assert rel_max(g.numpy(), u) < 1e-4
    assert calls == ([(0.1, True, "fused_fpn" in switches)] * 3 if switches else [])


def test_mobilenet_int8_scales_carried(mobilenet_int8):
    """Only the pointwise convs, the FPN and the SSH modules are int8: 13
    pointwise convs, 5 FPN convs, 15 SSH convs. The first conv and every
    depthwise conv stay exact."""
    variables = mobilenet_int8[0]
    scales = convert.act_scales("retinaface", variables)
    model = port_int8(RetinaFace(backbone=MNET, quant=True), "retinaface", variables)
    assert set(scales) == set(layers.q_modules(model)) and len(scales) == 13 + 5 + 15
    assert all(k.endswith(".3") for k in scales if k.startswith("body."))
    assert isinstance(model.body.stage1[0][0], nn.Conv2d)
    for block in list(model.body.stage1)[1:] + list(model.body.stage2) + list(model.body.stage3):
        assert isinstance(block, ConvDW) and isinstance(block[0], nn.Conv2d)
        assert block[0].groups == block[0].in_channels and isinstance(block[3], layers.QConv)
    np.testing.assert_array_equal(
        float(model.body.stage2[0][3].amax),
        variables["act_scales"]["body"]["stage2_0"]["pw"]["conv"]["amax"])


def test_mobilenet_fused_switches(mobilenet_pair):
    """The chain switches have nothing to fuse in the mobilenet body: they are
    accepted and change nothing. An unknown backbone raises."""
    variables, x, _ = mobilenet_pair
    sd = convert.retinaface(variables)
    plain = port(RetinaFace(backbone=MNET), sd)
    chains = port(RetinaFace(backbone=MNET, fused_layer1=True, fused_tails=True,
                             fused_entries=True), sd)
    assert isinstance(chains.body, MobileNetV1Body)
    with torch.no_grad():
        for g, w in zip(chains(torch.from_numpy(x)), plain(torch.from_numpy(x))):
            assert torch.equal(g, w)
    with pytest.raises(ValueError):
        RetinaFace(backbone="vgg")


# ------------------------------------------------------------- the round trip

def _conv_bn(inp, oup, stride, leaky=0.1):
    return nn.Sequential(nn.Conv2d(inp, oup, 3, stride, 1, bias=False), nn.BatchNorm2d(oup),
                         nn.LeakyReLU(negative_slope=leaky, inplace=True))


def _conv_dw(inp, oup, stride, leaky=0.1):
    return nn.Sequential(
        nn.Conv2d(inp, inp, 3, stride, 1, groups=inp, bias=False), nn.BatchNorm2d(inp),
        nn.LeakyReLU(negative_slope=leaky, inplace=True),
        nn.Conv2d(inp, oup, 1, 1, 0, bias=False), nn.BatchNorm2d(oup),
        nn.LeakyReLU(negative_slope=leaky, inplace=True))


class TwinMobileNetV1(nn.Module):
    """The reference's MobileNetV1-0.25 body (retina_face_net.py), as its
    IntermediateLayerGetter leaves it: stage1..3, no classifier."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(_conv_bn(3, 8, 2), _conv_dw(8, 16, 1), _conv_dw(16, 32, 2),
                                    _conv_dw(32, 32, 1), _conv_dw(32, 64, 2), _conv_dw(64, 64, 1))
        self.stage2 = nn.Sequential(_conv_dw(64, 128, 2), *[_conv_dw(128, 128, 1)
                                                            for _ in range(5)])
        self.stage3 = nn.Sequential(_conv_dw(128, 256, 2), _conv_dw(256, 256, 1))

    def forward(self, x):
        s1 = self.stage1(x)
        s2 = self.stage2(s1)
        return {"1": s1, "2": s2, "3": self.stage3(s2)}


class TwinMobileRetinaFace(twins.TwinRetinaFace):
    """``TwinRetinaFace`` with the mobilenet body and the 64-wide FPN, SSH
    modules and heads."""

    def __init__(self):
        super().__init__()
        self.body = TwinMobileNetV1()
        self.fpn = twins.TwinFPN([64, 128, 256], 64)
        self.ssh1, self.ssh2, self.ssh3 = (twins.TwinSSH(64, 64) for _ in range(3))
        for heads in (self.ClassHead, self.BboxHead, self.LandmarkHead):
            for h in heads:
                h.conv1x1 = nn.Conv2d(64, h.conv1x1.out_channels, 1)


def test_twin_round_trip_mobilenet():
    """Reference state dict -> JAX tree (``convert_retinaface(backbone=
    "mobilenet0.25")``) -> the port's state dict: the same names, the same
    tensors, the same outputs as the torch twin."""
    from test_model_parity import randomize_state

    twin = TwinMobileRetinaFace().eval()
    randomize_state(twin, scale=0.05)
    variables = jax_convert.convert_retinaface(twin.state_dict(), backbone=MNET)
    sd = convert.retinaface(variables)
    want_sd = twin.state_dict()
    assert set(sd) == set(want_sd)
    for k, v in want_sd.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(sd[k], v, atol=0, rtol=0, msg=k)
    model = port(RetinaFace(backbone=MNET), sd)
    x = torch.from_numpy(
        np.random.default_rng(14).normal(size=(1, 3, 64, 64)).astype(np.float32) * 20)
    with torch.no_grad():
        for g, w in zip(model(x.permute(0, 2, 3, 1)), twin(x)):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------- stage and the builder

@pytest.mark.parametrize("stride", [1, 2])
def test_detect_stage_mobilenet_matches_jax(stride):
    """The real detect stage with the mobilenet model at the 448 bucket of a
    640 x 360 clip (448 x 252 letterbox: prior rows 32 x 56, 16 x 28, 8 x 14
    x 2 anchors) on the same, already letterboxed frames; with stride 2 the
    network sees frames 0 and 2 of the batch of 4 and all four frames stay on
    the device. The packed ``[B / stride, K, 16]`` contract holds."""
    variables = init_variables(JaxRetinaFace(backbone=MNET), (jnp.zeros((1, 64, 64, 3)),), seed=15)
    cfg = DetectorConfig(backbone=MNET, long_side=448, batch_size=4, stride=stride,
                         transfer_format="bgr", threshold=0.3, dtype="float32")
    frames = np.random.default_rng(16).integers(0, 255, (4, 252, 448, 3), dtype=np.uint8)
    want = JaxDetectStage(cfg, variables, dtype=jnp.float32)(frames)
    model = port(RetinaFace(backbone=MNET), convert.retinaface(variables))
    stage = DetectStage(cfg, model, device="cpu")
    packed, scale, frames_dev = stage.dispatch(frames)
    assert tuple(packed.shape) == (4 // stride, 64, 16) and tuple(frames_dev.shape) == frames.shape
    assert stage._priors_for(252, 448).shape == ((32 * 56 + 16 * 28 + 8 * 14) * 2, 4)
    got = stage.unpack(packed.numpy(), scale)
    assert want.keep.shape == got.keep.shape == (4 // stride, 64)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-2, rtol=1e-3)
    np.testing.assert_allclose(got.landmarks, want.landmarks, atol=1e-2, rtol=1e-3)
    np.testing.assert_array_equal(got.keep, want.keep)


def test_detect_stage_stride_and_backbone_checks():
    model = RetinaFace(backbone=MNET).eval()
    cfg = DetectorConfig(backbone=MNET, long_side=64, batch_size=8, stride=3,
                         transfer_format="bgr", dtype="float32")
    with pytest.raises(ValueError, match="must divide batch_size"):
        DetectStage(cfg, model, device="cpu")
    with pytest.raises(ValueError, match="does not fit the model"):
        DetectStage(dataclasses.replace(cfg, stride=1, backbone="resnet50"), model, device="cpu")
    stage = DetectStage(dataclasses.replace(cfg, stride=4), model, device="cpu")
    frames = np.zeros((8, 48, 64, 3), np.uint8)
    assert stage.dispatch(frames)[0].shape[0] == 2


def test_detect_stage_mobilenet_int8_calibrates_like_jax():
    """The int8 mobilenet stage seeds its scales on the JAX package's noise
    frames and refines them on the first real batch's first two frames, with
    the unfused model also when it serves through the fused kernel."""
    jm = JaxRetinaFace(backbone=MNET, dtype=jnp.float32, quant=True)
    variables = numpy_tree(init_variables(jm, (jnp.zeros((1, 64, 64, 3)),), seed=17))
    cfg = DetectorConfig(backbone=MNET, long_side=64, batch_size=2, transfer_format="bgr",
                         threshold=0.3, dtype="float32", quant="int8", fused_ssh=True,
                         fused_fpn=True)
    jax_stage = JaxDetectStage(cfg, variables, dtype=jnp.float32)
    model = port(RetinaFace(backbone=MNET, quant=True, fused_ssh=True, fused_fpn=True),
                 convert.retinaface(variables)).requires_grad_(False)
    stage = DetectStage(cfg, model, device="cpu")
    frames = np.random.default_rng(18).integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    want = jax_stage(frames)
    packed, scale, _ = stage.dispatch(frames)
    got = stage.unpack(packed.numpy(), scale)
    assert stage.calibration_forwards == 2 and stage._real_calibrated
    jax_scales = convert.act_scales("retinaface", {**variables, "act_scales": numpy_tree(
        jax_stage.variables["act_scales"])})
    ours = layers.act_scales(model)
    assert set(ours) == set(jax_scales) and len(ours) == 33
    # a value flipped upstream moves a later conv's input max by a step: 2 %
    for k in ours:
        np.testing.assert_allclose(float(ours[k]), float(jax_scales[k]), rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(got.scores, want.scores, atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_builder_builds_the_mobilenet_detector(tmp_path, quant):
    """``cfg.detector.backbone`` chooses the model: seeded init, or a JAX
    mobilenet tree handed in; a tree of the other backbone does not load."""
    from test_torch_pipeline import slice_config

    cfg = slice_config(str(tmp_path / "no_weights"))
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(
        cfg.detector, backbone=MNET, quant=quant, fused_ssh=True, fused_fpn=True))
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu")
    det = pipe.detect.model
    assert isinstance(det.body, MobileNetV1Body) and det.out_ch == 64 and det.fused_fpn
    assert det.quant == (quant == "int8")
    assert all(m.calibrated for m in layers.q_modules(det).values())
    jm = JaxRetinaFace(backbone=MNET)
    variables = numpy_tree(init_variables(jm, (jnp.zeros((1, 64, 64, 3)),), seed=19))
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu",
                          jax_variables={"retinaface": variables})
    np.testing.assert_array_equal(
        pipe.detect.model.body.stage1[0][0].weight.numpy(),
        np.transpose(variables["params"]["body"]["stage1_0"]["conv"]["kernel"], (3, 2, 0, 1)))
    r50 = numpy_tree(init_variables(JaxRetinaFace(backbone="resnet50"),
                                    (jnp.zeros((1, 64, 64, 3)),), seed=19))
    with pytest.raises(RuntimeError, match="state_dict"):
        build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu",
                       jax_variables={"retinaface": r50})
