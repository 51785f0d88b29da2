"""The int8 serving path of avcer_tpu_torch against the JAX package on the
CPU: the int8 products and the three Q modules in their three scale modes,
the plain versions of the fused kernels' int8 mode and of the flat kernel
against the Pallas kernels in interpret mode, the int8 models (fused and
unfused) with the JAX tree's ``act_scales`` carried across. The stages and
the slice as a whole are in tests/test_torch_int8_pipeline.py.

Inputs and weights come from numpy generators and go to both sides. Both
sides sum int8 products exactly, so what can differ is one f32 ulp in a scale
or a quotient; where that flips a quantised value the result moves by one
quantisation step of one term, which the stated tolerances allow for."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.models import layers as jax_layers
from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
from avcer_tpu.models.emotion_resnet import EmotionResNet50 as JaxEmotionResNet50
from avcer_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V2Config
from avcer_tpu.ops.pallas import fused_resnet_kernel as jax_frk
from avcer_tpu.ops.pallas.fused_ssh_kernel import fused_ssh_heads as jax_fused_ssh_heads

from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk
from avcer_tpu_torch.ops.cuda import fused_ssh_kernel as fsk

from test_torch_models import TINY_W2V2, port, randomize_stats
from torch_fused_cases import (chain_weights, quant_tensors, quantize_folded, ssh_weights,
                               tensors)

torch.set_num_threads(2)


def rel_max(got, want) -> float:
    """The JAX package's measure for its fused int8 tests: the largest
    difference over the largest reference value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


# ------------------------------------------------------------ int8 products

# the last one is the emotion CNN's stem: TF 'same' padding, asymmetric, which
# the port applies to the input before the conv (a zero quantises to zero)
CONVS = [(1, 1, 0), (3, 1, 1), (3, 2, 1), (1, 2, 0), (7, 2, ((2, 3), (2, 3)))]


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("k,stride,pad", CONVS)
def test_int8_conv_matches_jax(k, stride, pad, static):
    """Same quantised values and exact sums on both sides: equal up to the
    last f32 bit of the dequantising multiply."""
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 13, 11, 8)).astype(np.float32)
    w = (rng.normal(size=(k, k, 8, 24)) * 0.1).astype(np.float32)
    amax = np.float32(3.0) if static else None
    jpad = ((pad, pad), (pad, pad)) if isinstance(pad, int) else pad
    want = jax_layers.int8_conv(jnp.asarray(x), jnp.asarray(w), strides=(stride, stride),
                                padding=jpad, out_dtype=jnp.float32,
                                act_amax=None if amax is None else jnp.asarray(amax))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if not isinstance(pad, int):
        xt, pad = torch.nn.functional.pad(xt, [*pad[1], *pad[0]]), 0
    got = layers.int8_conv(xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=(stride, stride),
                           padding=pad, out_dtype=torch.float32,
                           act_amax=None if amax is None else torch.tensor(amax))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(static, dtype):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3, 5, 20)).astype(np.float32)
    w = (rng.normal(size=(20, 12)) * 0.2).astype(np.float32)
    amax = np.float32(2.5) if static else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_layers.int8_matmul(jnp.asarray(x, jdt), jnp.asarray(w), out_dtype=jdt,
                                  act_amax=None if amax is None else jnp.asarray(amax))
    got = layers.int8_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).t(),
                             out_dtype=tdt, act_amax=None if amax is None else torch.tensor(amax))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    # bf16: one rounding of the same f32 value on both sides
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-6, rtol=1e-6)


def test_int_mm_pads_small_and_odd_shapes():
    """``torch._int_mm`` on the card wants M > 16 and K, N multiples of 8:
    the wrapper pads with zeros, which add nothing to an exact sum."""
    rng = np.random.default_rng(22)
    for m, k, n in ((1, 147, 64), (5, 20, 7), (40, 16, 8)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
        got = layers.int_mm(a, b)
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        assert torch.equal(got.long(), a.long() @ b.long().t())


def _q_module_pair(kind):
    """(JAX module, its input [NHWC / NLC / ..K], the port's module factory,
    input layout change for the port, output layout change back)."""
    if kind == "conv":
        jm = jax_layers.QConv(12, (3, 3), strides=(2, 2), padding=1, dtype=jnp.float32)
        shape = (2, 9, 10, 6)
        make = lambda: layers.QConv(6, 12, 3, stride=2, padding=1)
        to, back = (lambda t: t.permute(0, 3, 1, 2)), (lambda t: t.permute(0, 2, 3, 1))
        wperm = (3, 2, 0, 1)
    elif kind == "conv1d":
        jm = jax_layers.QConv1d(10, kernel_size=3, strides=2, dtype=jnp.float32)
        shape = (2, 21, 6)
        make = lambda: layers.QConv1d(6, 10, 3, stride=2)
        to, back = (lambda t: t.transpose(1, 2)), (lambda t: t.transpose(1, 2))
        wperm = (2, 1, 0)
    else:
        jm = jax_layers.QDense(10, dtype=jnp.float32)
        shape = (2, 7, 6)
        make = lambda: layers.QDense(6, 10)
        to = back = lambda t: t
        wperm = (1, 0)
    return jm, shape, make, to, back, wperm


@pytest.mark.parametrize("mode", ["uncalibrated", "calibrating", "calibrated"])
@pytest.mark.parametrize("kind", ["conv", "conv1d", "dense"])
def test_q_modules_match_jax(kind, mode):
    """QConv, QConv1d and QDense in the three modes of the activation scale:
    dynamic (no ``act_scales``), calibrating (the running max takes the input
    in and is used) and calibrated (a static scalar, here from a louder
    input than the one served)."""
    jm, shape, make, to, back, wperm = _q_module_pair(kind)
    rng = np.random.default_rng(23)
    x = rng.normal(size=shape).astype(np.float32)
    loud = (rng.normal(size=shape) * 2).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": {"kernel": np.asarray(v["params"]["kernel"]),
                         "bias": rng.normal(size=v["params"]["bias"].shape).astype(np.float32)}}
    m = make()
    m.load_state_dict({"weight": torch.from_numpy(np.transpose(params["params"]["kernel"], wperm)
                                                  .copy()),
                       "bias": torch.from_numpy(params["params"]["bias"])})
    m.eval().requires_grad_(False)
    if mode == "uncalibrated":
        want = jm.apply(params, jnp.asarray(x))
        got = m(to(torch.from_numpy(x)))
        assert not m.calibrated
    elif mode == "calibrating":
        _, upd = jm.apply(params, jnp.asarray(loud), mutable=["act_scales"])
        want, upd = jm.apply({**params, **upd}, jnp.asarray(x), mutable=["act_scales"])
        with layers.calibrating(m):
            m(to(torch.from_numpy(loud)))
            got = m(to(torch.from_numpy(x)))
        np.testing.assert_array_equal(m.amax.numpy(), np.asarray(upd["act_scales"]["amax"]))
        assert float(m.amax) == np.abs(loud).max()  # the running max kept the louder input
    else:
        _, upd = jm.apply(params, jnp.asarray(loud), mutable=["act_scales"])
        want = jm.apply({**params, **upd}, jnp.asarray(x))
        with layers.calibrating(m):
            m(to(torch.from_numpy(loud)))
        before = m.amax.clone()
        got = m(to(torch.from_numpy(x) * 10))  # a served input never moves the scale
        assert torch.equal(m.amax, before) and m.calibrated
        got = m(to(torch.from_numpy(x)))
    np.testing.assert_allclose(back(got).numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert set(m.state_dict()) == {"weight", "bias"}  # the exact module's state dict


# ------------------------------------------- the fused kernels' plain versions

# An "id" first block needs 128 input channels on the JAX side (its wrapper
# pads the input channels to the TPU's lane width and cannot pad an identity).
# blocks, cin, planes, frame, band: stride-1, the two stride-2 entries, odd
# sizes, and bands that split the frame (band 8 over 23 or 24 rows)
QCHAINS = [(("ds", "id", "id"), 16, 8, (23, 17), 8), (("id", "id"), 128, 32, (24, 16), 8),
           (("s2ds", "id", "id"), 16, 8, (23, 17), 8), (("s2ds", "id"), 32, 8, (24, 16), 32),
           (("s2pre", "id", "id"), 32, 8, (23, 17), 8), (("s2pre", "id"), 32, 8, (24, 16), 4),
           (("id",), 128, 32, (13, 11), 32)]


@pytest.mark.parametrize("blocks,cin,planes,hw,band", QCHAINS)
def test_fused_chain_plain_int8_matches_jax(blocks, cin, planes, hw, band):
    """``fused_chain_plain(act_s=...)`` against the Pallas kernel's int8 mode
    in interpret mode, f32 compute dtype, on random int8 folds. Within 1e-4
    of the largest value, the JAX package's own bound for its fused int8
    chains (measured: a few f32 ulps; XLA may join the epilogue's multiply
    and add into one FMA)."""
    rng = np.random.default_rng(30)
    x = np.maximum(rng.normal(size=(2, *hw, cin)), 0).astype(np.float32)
    folded, act_s = quantize_folded(rng, chain_weights(rng, cin, planes, blocks))
    want = jax_frk.fused_chain(jnp.asarray(x), tuple(jnp.asarray(a) for a in folded), blocks,
                               interpret=True, band=band, act_s=jnp.asarray(act_s))
    got = frk.fused_chain(torch.from_numpy(x), quant_tensors(folded), blocks,
                          act_s=torch.from_numpy(act_s))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert rel_max(got.numpy(), want) < 1e-4


def test_fused_chain_plain_int8_matches_jax_bf16():
    """bf16 activations between the int8 convs, as served: the same rounding
    points on both sides (one rounding to bf16 per conv), so results agree to
    the bf16 ulp (2**-8 relative) where an f32 ulp crosses a rounding
    boundary or flips a quantised value."""
    blocks, cin, planes = ("ds", "id", "id"), 16, 8
    rng = np.random.default_rng(31)
    x = jnp.asarray(np.maximum(rng.normal(size=(2, 24, 16, cin)), 0).astype(np.float32),
                    jnp.bfloat16)
    folded, act_s = quantize_folded(rng, chain_weights(rng, cin, planes, blocks))
    want = jax_frk.fused_chain(x, tuple(jnp.asarray(a) for a in folded), blocks, interpret=True,
                               band=8, act_s=jnp.asarray(act_s))
    got = frk.fused_chain(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16(),
                          quant_tensors(folded), blocks, act_s=torch.from_numpy(act_s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -6, rtol=2 ** -6)


# name, ci, C, leaky, lateral, merge, up, emit_feature
QSSH_CASES = [("ssh_heads", 32, 32, 0.0, False, False, False, False),
              ("lateral_emit", 48, 32, 0.0, True, False, False, True),
              ("lateral_up_merge_emit", 48, 32, 0.0, True, True, True, True),
              ("leaky_c64_fpn", 32, 64, 0.1, True, True, True, True)]


@pytest.mark.parametrize("name,ci,c,leaky,lat,merge,has_up,emit", QSSH_CASES)
def test_fused_ssh_heads_plain_int8_matches_jax(name, ci, c, leaky, lat, merge, has_up, emit):
    """``fused_ssh_heads_plain(act_s=...)`` against the Pallas kernel's int8
    option in interpret mode (band 8 splits the 13 rows), f32: the lateral,
    the merge and the five SSH convs in int8, the heads exact. Bound as for
    the chains."""
    rng = np.random.default_rng(32)
    x = np.maximum(rng.normal(size=(2, 13, 11, ci)), 0).astype(np.float32)
    up = rng.normal(size=(2, 13, 11, c)).astype(np.float32) if has_up else None
    convs, heads, fl, fm = ssh_weights(rng, ci, c, lat, merge)
    scales = []
    if lat:
        fl, s = quantize_folded(rng, fl)
        scales.append(s)
    if merge:
        fm, s = quantize_folded(rng, fm)
        scales.append(s)
    convs, s = quantize_folded(rng, convs)
    act_s = np.concatenate(scales + [s])

    def j(arrays):
        return None if arrays is None else tuple(jnp.asarray(a) for a in arrays)

    want = jax_fused_ssh_heads(jnp.asarray(x), j(convs), j(heads), leaky=leaky, interpret=True,
                               band=8, act_s=jnp.asarray(act_s), fpn_lat=j(fl), fpn_merge=j(fm),
                               up=None if up is None else jnp.asarray(up), emit_feature=emit)
    got = fsk.fused_ssh_heads(
        torch.from_numpy(x), quant_tensors(convs), tensors(heads), leaky,
        fpn_lat=quant_tensors(fl), fpn_merge=quant_tensors(fm),
        up=None if up is None else torch.from_numpy(up), emit_feature=emit,
        act_s=torch.from_numpy(act_s))
    assert len(got) == len(want) == 3 + emit
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_max(g.numpy(), w) < 1e-4


# the three cases of the JAX package's test of its flat kernel
FLAT_CASES = [((2, 13, 17, 64), ("ds", "id", "id"), 8), ((1, 37, 29, 128), ("id", "id"), 16),
              ((1, 24, 16, 64), ("ds",), 24)]


def flat_case(shape, blocks):
    rng = np.random.default_rng(33)
    cin = shape[-1]
    p, co = 24, cin if blocks[0] == "id" else 64

    def mk(k, ci, c):
        w = (rng.normal(size=(k, k, ci, c)) * 0.1).astype(np.float32)
        return [w[0, 0] if k == 1 else w, (rng.normal(size=(1, c)) * 0.2 + 1).astype(np.float32),
                (rng.normal(size=(1, c)) * 0.1).astype(np.float32)]

    folded = []
    for kind in blocks:
        folded += mk(1, cin, p) + mk(3, p, p) + mk(1, p, co)
        if kind == "ds":
            folded += mk(1, cin, co)
        cin = co
    return rng.normal(size=shape).astype(np.float32), folded


@pytest.mark.parametrize("shape,blocks,band", FLAT_CASES)
def test_fused_chain_flat_plain_matches_jax(shape, blocks, band):
    """``fused_chain_flat`` on the CPU (its plain version over flat bands)
    against the Pallas flat kernel in interpret mode: f32, only the order of
    the f32 sums differs."""
    x, folded = flat_case(shape, blocks)
    want = jax_frk.fused_chain_flat(jnp.asarray(x), tuple(jnp.asarray(a) for a in folded),
                                    blocks, interpret=True, band=band)
    got = frk.fused_chain_flat(torch.from_numpy(x), tensors(folded), blocks, band=band)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,blocks,band", FLAT_CASES)
def test_fused_chain_flat_plain_equals_chain_plain(shape, blocks, band):
    """The flat kernel's contract in the JAX package is equality with the
    banded kernel. The plain versions hold it over the three cases, for every
    band height: the flat bands change where a pixel is computed, not what."""
    x, folded = flat_case(shape, blocks)
    want = frk.fused_chain_plain(torch.from_numpy(x), tensors(folded), blocks)
    for b in (band, 5, 32):
        got = frk.fused_chain_flat_plain(torch.from_numpy(x), tensors(folded), blocks, band=b)
        assert torch.equal(got, want), b


@pytest.mark.parametrize("held", [{1: 264, 2: 132, 3: 79, 4: 62}, {1: 132, 2: 66, 3: 44, 4: 33}])
@pytest.mark.parametrize("shape,blocks,band", FLAT_CASES)
def test_fused_chain_flat_plain_at_the_plans_band_height(shape, blocks, band, held):
    """The plain version over the flat bands of the plan's height (pitch W +
    2n) equals the chain's plain version."""
    x, folded = flat_case(shape, blocks)
    b, h, w, cin = shape
    cout = cin if blocks[0] == "id" else 64
    plan = frk.flat_plan(b, h, w, len(blocks), cout, 24, 4, held, band)
    got = frk.fused_chain_flat_plain(torch.from_numpy(x), tensors(folded), blocks, band=band,
                                     th=plan["th"])
    assert torch.equal(got, frk.fused_chain_plain(torch.from_numpy(x), tensors(folded), blocks))


def test_fused_chain_flat_refusals_and_plan():
    x, folded = flat_case((1, 6, 5, 20), ("id",))
    with pytest.raises(ValueError, match="stride-1 chains only"):
        frk.fused_chain_flat(torch.from_numpy(x), tensors(folded), ("s2pre",))
    with pytest.raises(ValueError, match="projection entry"):  # 20 channels, no projection
        frk._flat_inputs(torch.from_numpy(x), tensors(folded), ("id",), 32, 8)
    # a projection entry pads the input's channels (and its readers' rows)
    x, folded = flat_case((1, 6, 5, 20), ("ds",))
    xp, mask, padded, plan = frk._flat_inputs(torch.from_numpy(x), tensors(folded), ("ds",), 32, 8)
    assert xp.shape == (1, (6 + 2) * 7, 24) and padded[0].shape[0] == padded[9].shape[0] == 24
    assert mask.shape == (1, 8 * 7) and int(mask.sum()) == 6 * 5
    # detector layer1 on a card that holds 264 / 132 / 79 / 62 clusters of 1-4
    # blocks: a pitch of 160 + 6 columns (no rounding to the TPU's 8
    # sublanes), 23 rows a band, two blocks a band
    plan = frk.flat_plan(32, 90, 160, 3, 256, 64, 2, {1: 264, 2: 132, 3: 79, 4: 62})
    assert {k: plan[k] for k in ("th", "nb", "pitch", "rows", "nwork", "cluster", "grid")} == {
        "th": 23, "nb": 4, "pitch": 166, "rows": 29, "nwork": 128, "cluster": 2, "grid": 256}
    before = frk.fused_chain_flat.launches
    frk.fused_chain_flat(torch.from_numpy(x), tensors(folded), ("ds",))
    assert frk.fused_chain_flat.launches == before  # the CPU path launches nothing


# ------------------------------------------------------------- int8 models

def numpy_tree(variables):
    return jax.tree.map(np.asarray, dict(variables))


def calibrated(jax_model, variables, x):
    """``variables`` with the ``act_scales`` of one calibration forward."""
    _, upd = jax_model.apply(variables, jnp.asarray(x), mutable=["act_scales"])
    return numpy_tree({**variables, "act_scales": upd["act_scales"]})


def port_int8(model, family, variables):
    """The port's int8 model with the tree's weights and its scales."""
    port(model, convert.CONVERTERS[family](variables))
    layers.load_act_scales(model, convert.act_scales(family, variables))
    return model.requires_grad_(False)


@pytest.fixture(scope="module")
def retinaface_int8():
    jm = JaxRetinaFace(backbone="resnet50", dtype=jnp.float32, quant=True)
    variables = randomize_stats(init_variables(jm, (jnp.zeros((1, 64, 64, 3)),), seed=1), 1)
    # A quotient one f32 ulp apart between two implementations flips a
    # quantised value, the convs downstream quantise the difference again, and
    # the outputs then differ by percents: the JAX model's own fused and
    # unfused forwards do that on some inputs (seed 40 here: 3 %). This input
    # has no such flip on either side, so the tight bounds below hold.
    rng = np.random.default_rng(41)
    x = (rng.normal(size=(1, 72, 56, 3)) * 20).astype(np.float32)
    variables = calibrated(jm, variables, x)
    return variables, x, jm.apply(variables, jnp.asarray(x))


ALL_FUSED = dict(fused_layer1=True, fused_tails=True, fused_entries=True, fused_ssh=True,
                 fused_fpn=True)


@pytest.mark.parametrize("switches", [{}, dict(fused_ssh=True), ALL_FUSED],
                         ids=["unfused", "fused_ssh", "all_fused"])
def test_retinaface_int8_matches_jax(retinaface_int8, switches):
    """The int8 detector, f32 compute dtype, the same weights and the same
    ``act_scales`` (carried by ``core.convert``): the port against the JAX
    model under the same switches (its Pallas kernels in interpret mode), and
    against the unfused JAX int8 model, within the JAX package's own bound
    for fused against unfused int8 (1e-4 of the largest value)."""
    variables, x, want_unfused = retinaface_int8
    model = port_int8(RetinaFace(quant=True, **switches), "retinaface", variables)
    got = model(torch.from_numpy(x))
    want = want_unfused if not switches else JaxRetinaFace(
        backbone="resnet50", dtype=jnp.float32, quant=True, **switches).apply(
            variables, jnp.asarray(x))
    for g, w, u in zip(got, want, want_unfused):
        assert g.shape == w.shape
        assert rel_max(g.numpy(), w) < 1e-4
        assert rel_max(g.numpy(), u) < 1e-4


def test_retinaface_int8_scales_carried(retinaface_int8):
    """Every quantised conv of the JAX tree finds its module: the bottleneck
    convs of the body, the FPN and the SSH modules; the stem and the heads
    are not int8. A tree without ``act_scales`` leaves the port
    uncalibrated."""
    variables = retinaface_int8[0]
    scales = convert.act_scales("retinaface", variables)
    model = port_int8(RetinaFace(quant=True), "retinaface", variables)
    assert set(scales) == set(layers.q_modules(model)) and len(scales) == 52 + 5 + 15
    assert "body.conv1" not in scales and not any("Head" in k for k in scales)
    np.testing.assert_array_equal(
        float(model.body.layer2[0].downsample[0].amax),
        variables["act_scales"]["body"]["layer2_0"]["downsample_conv"]["amax"])
    bare = {k: v for k, v in variables.items() if k != "act_scales"}
    assert convert.act_scales("retinaface", bare) is None
    assert not any(m.calibrated for m in layers.q_modules(
        port(RetinaFace(quant=True), convert.retinaface(bare))).values())


@pytest.mark.parametrize("switches", [{}, dict(fused=True, fused_entries=True)],
                         ids=["unfused", "fused"])
def test_emotion_resnet50_int8_matches_jax(switches):
    """The int8 emotion CNN (stem quantised too, fc head exact), inputs
    scaled by 50 as the JAX package's test: within its bound for fused against
    unfused int8 (atol 2e-3, rtol 1e-3), against the JAX model under the same
    switches and against the unfused one."""
    jm = JaxEmotionResNet50(num_classes=7, dtype=jnp.float32, quant=True)
    variables = randomize_stats(init_variables(jm, (jnp.zeros((1, 64, 64, 3)),), seed=2), 2)
    x = (np.random.default_rng(41).normal(size=(2, 64, 64, 3)) * 50).astype(np.float32)
    variables = calibrated(jm, variables, x)
    want_unfused = jm.apply(variables, jnp.asarray(x))
    want = JaxEmotionResNet50(num_classes=7, dtype=jnp.float32, quant=True, **switches).apply(
        variables, jnp.asarray(x))
    model = port_int8(EmotionResNet50(7, quant=True, **switches), "emotion_resnet50", variables)
    assert isinstance(model.conv_layer_s2_same, layers.QConv) and len(
        layers.q_modules(model)) == 53
    got = model(torch.from_numpy(x))
    for g, w, u in zip(got, want, want_unfused):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(u), atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def expr_int8():
    cfg = JaxW2V2Config(**TINY_W2V2, quant=True)
    jm = JaxExprModel("v3", 8, cfg, dtype=jnp.float32)
    variables = randomize_stats(init_variables(jm, (jnp.zeros((1, 17000)),), seed=3), 3)
    # as for the detector: this input flips no quantised value between the two
    # sides (seed 42 flips some in the extractor and moves 1.5 % of the
    # features by up to 0.04; int8 against exact differs by 0.02 in the logits)
    rng = np.random.default_rng(44)
    wav = rng.normal(size=(2, 17000)).astype(np.float32)
    return jm, calibrated(jm, variables, wav), wav


def test_expr_model_int8_matches_jax(expr_int8):
    """wav2vec2 with QConv1d in extractor layers 1-6 and QDense in q, k, v,
    out and both FFN projections, then ExprModel V3 (exact), f32: the bound of
    the exact model's parity test (atol 5e-4, rtol 1e-3)."""
    jm, variables, wav = expr_int8
    model = port_int8(ExprModel("v3", 8, Wav2Vec2Config(**TINY_W2V2, quant=True)), "expr_model",
                      variables)
    qs = layers.q_modules(model)
    assert len(qs) == 6 + 6 * TINY_W2V2["num_layers"]
    assert isinstance(model.wav2vec2.feature_extractor.conv_layers[0].conv, torch.nn.Conv1d)
    assert isinstance(model.wav2vec2.feature_extractor.conv_layers[1].conv, layers.QConv1d)
    got = model(torch.from_numpy(wav))
    want = jm.apply(variables, jnp.asarray(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)


def test_w2v_modes_match_jax(expr_int8):
    """``features_only`` and ``from_features`` split the forward where the
    JAX model splits it, and compose to the full forward."""
    jm, variables, wav = expr_int8
    model = port_int8(ExprModel("v3", 8, Wav2Vec2Config(**TINY_W2V2, quant=True)), "expr_model",
                      variables)
    feats = model(torch.from_numpy(wav), w2v_mode="features_only")
    want = jm.apply(variables, jnp.asarray(wav), w2v_mode="features_only")
    assert tuple(feats.shape) == want.shape
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    full = model(torch.from_numpy(wav))
    assert torch.equal(model(feats, w2v_mode="from_features"), full)
    want = jm.apply(variables, want, w2v_mode="from_features")
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="unknown wav2vec2 mode"):
        model(torch.from_numpy(wav), w2v_mode="hidden")
