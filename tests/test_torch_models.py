"""avcer_tpu_torch models against the JAX package's at small inputs, f32 on
both sides, the same weights carried across with avcer_tpu_torch.core.convert;
and a state-dict round trip from each reference torch twin."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.core import convert as jax_convert
from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
from avcer_tpu.models.emotion_resnet import EmotionResNet50 as JaxEmotionResNet50
from avcer_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from avcer_tpu.models.temporal_lstm import TemporalLSTM as JaxTemporalLSTM
from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V2Config

from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config

import torch_twins as twins

torch.set_num_threads(2)

TINY_W2V2 = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                 conv_dim=(16,) * 7)


def randomize_stats(variables, seed: int):
    """Random BN running stats and norm affines, so the conversion of every
    leaf kind is exercised (the JAX init leaves them at 0/1)."""
    rng = np.random.default_rng(seed)

    def walk(node, kind):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val, kind)
            elif key == "var":
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif key == "mean":
                out[key] = (rng.normal(size=val.shape) * 0.1).astype(np.float32)
            elif kind == "params" and key == "scale":
                out[key] = (1 + rng.normal(size=val.shape) * 0.1).astype(np.float32)
            elif kind == "params" and key == "bias":
                out[key] = (rng.normal(size=val.shape) * 0.05).astype(np.float32)
            else:
                out[key] = val
        return out

    return {kind: walk(tree, kind) for kind, tree in variables.items()}


def port(module: torch.nn.Module, state_dict) -> torch.nn.Module:
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def retinaface_pair():
    variables = randomize_stats(init_variables(
        JaxRetinaFace(backbone="resnet50"), (jnp.zeros((1, 64, 64, 3)),), seed=1), 1)
    return variables, port(RetinaFace(), convert.retinaface(variables))


def test_retinaface_matches_jax(retinaface_pair):
    variables, model = retinaface_pair
    x = (np.random.default_rng(0).normal(size=(2, 64, 64, 3)) * 20).astype(np.float32)
    want = jax.jit(JaxRetinaFace(backbone="resnet50").apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    # test_model_parity.py's RetinaFace bounds (conv sums in another order)
    for g, w, atol in zip(got, want, (1e-3, 1e-4, 1e-3)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-2)


def test_emotion_resnet50_matches_jax():
    variables = randomize_stats(init_variables(
        JaxEmotionResNet50(num_classes=7), (jnp.zeros((1, 64, 64, 3)),), seed=2), 2)
    model = port(EmotionResNet50(7), convert.emotion_resnet50(variables))
    x = (np.random.default_rng(1).normal(size=(2, 96, 112, 3)) * 3).astype(np.float32)
    want_logits, want_feat = jax.jit(JaxEmotionResNet50(num_classes=7).apply)(
        variables, jnp.asarray(x))
    with torch.no_grad():
        logits, feat = model(torch.from_numpy(x))
    # test_model_parity.py's emotion-CNN bounds
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), atol=1e-3, rtol=1e-2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-3, rtol=1e-2)


def test_temporal_lstm_matches_jax():
    variables = init_variables(JaxTemporalLSTM(7), (jnp.zeros((1, 10, 512)),), seed=3)
    model = port(TemporalLSTM(7), convert.temporal_lstm(variables))
    x = np.random.default_rng(2).normal(size=(3, 10, 512)).astype(np.float32)
    want = jax.jit(JaxTemporalLSTM(7).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)


def test_expr_model_v3_matches_jax():
    jax_model = JaxExprModel(variant="v3", num_classes=8,
                             wav2vec2_config=JaxW2V2Config(**TINY_W2V2))
    variables = randomize_stats(
        init_variables(jax_model, (jnp.zeros((1, 17000)),), seed=4), 4)
    model = port(ExprModel("v3", 8, Wav2Vec2Config(**TINY_W2V2)), convert.expr_model(variables))
    x = np.random.default_rng(3).normal(size=(2, 17000)).astype(np.float32)
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    # test_model_parity.py's ExprModel bound
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)


def _twin_round_trip(twin, jax_converter, port_converter, module, x):
    from test_model_parity import randomize_state

    twin.eval()
    randomize_state(twin, scale=0.05)
    variables = jax_converter(twin.state_dict())
    model = port(module, port_converter(variables))
    with torch.no_grad():
        return twin(x), model(x.permute(0, 2, 3, 1) if x.dim() == 4 else x)


def test_twin_round_trip_retinaface():
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(1, 3, 64, 64)).astype(np.float32) * 20)
    want, got = _twin_round_trip(twins.TwinRetinaFace(), jax_convert.convert_retinaface,
                                 convert.retinaface, RetinaFace(), x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_twin_round_trip_emotion_resnet50():
    x = torch.from_numpy(
        np.random.default_rng(5).normal(size=(2, 3, 64, 64)).astype(np.float32) * 3)
    want, got = _twin_round_trip(
        twins.TwinEmotionResNet50(7), jax_convert.convert_emotion_resnet50,
        convert.emotion_resnet50, EmotionResNet50(7), x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_twin_round_trip_temporal_lstm():
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 10, 512)).astype(np.float32))
    want, got = _twin_round_trip(twins.TwinTemporalLSTM(7), jax_convert.convert_temporal_lstm,
                                 convert.temporal_lstm, TemporalLSTM(7), x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_twin_round_trip_expr_model():
    """HF Wav2Vec2Model (2 layers, hidden 1024) + V3 head: the JAX converter
    fuses the positional conv's weight norm; the port loads the result."""
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 17000)).astype(np.float32))
    want, got = _twin_round_trip(
        twins.TwinExprModel("v3", 8, num_layers=2),
        lambda sd: jax_convert.convert_expr_model(sd, variant="v3", num_layers=2),
        convert.expr_model, ExprModel("v3", 8, Wav2Vec2Config(num_layers=2)), x)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)
