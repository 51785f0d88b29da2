"""Release checkpoints in the port (avcer_tpu_torch.core.checkpoint and
core.convert.release_state_dict) against the JAX package's loader on the same
files: the torch twins saved under the release names, in the release layout
(RetinaFace's ``module.`` prefix, the audio heads in a ``model_state_dict``
wrapper, the positional conv's weight norm in either naming scheme). Every
comparison is of parameters, with no forward pass."""

import logging
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from avcer_tpu.core import checkpoint as jax_checkpoint
from avcer_tpu.core import convert as jax_convert

from avcer_tpu_torch.core import checkpoint, convert
from avcer_tpu_torch.core import config as port_config
from avcer_tpu_torch.models.attention import sinusoidal_positional_encoding
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.pipeline.builder import build_pipeline

import torch_twins as twins

torch.set_num_threads(2)

W2V2_LAYERS = 2  # the twins' wav2vec2 depth (hidden 1024)
POS_CONV = "wav2vec2.encoder.pos_conv_embed.conv"


def random_stats_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random BatchNorm running statistics, so that their conversion counts;
    the weights keep the twins' own initialisation."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return model.eval()


def write_release_dir(d, seed: int = 0) -> str:
    """The release's files in ``d``, saved from the torch twins: the
    detector with the ``module.`` prefix of a DataParallel save, the V3 / 8
    head with the extra keys the reference's classes carry (HF's
    ``masked_spec_embed``, the sinusoid buffer, an unused LayerNorm) and the
    new weight-norm names, the V2 / 7 head with the old ones (``weight_g``,
    ``weight_v``), both inside the trainer's wrapper."""
    torch.manual_seed(seed)
    files = jax_checkpoint.TORCH_FILES
    os.makedirs(os.path.join(d, os.path.dirname(files["expr_model_8cl"])), exist_ok=True)
    os.makedirs(os.path.join(d, os.path.dirname(files["expr_model_7cl"])), exist_ok=True)
    rf = random_stats_(twins.TwinRetinaFace(), seed)
    torch.save({f"module.{k}": v for k, v in rf.state_dict().items()},
               os.path.join(d, files["retinaface"]))
    torch.save(random_stats_(twins.TwinEmotionResNet50(7), seed + 1).state_dict(),
               os.path.join(d, files["emotion_resnet50"]))
    torch.save(twins.TwinTemporalLSTM(7).state_dict(), os.path.join(d, files["temporal_lstm"]))
    sd8 = random_stats_(twins.TwinExprModel("v3", 8, W2V2_LAYERS), seed + 2).state_dict()
    assert f"{POS_CONV}.parametrizations.weight.original0" in sd8
    assert "wav2vec2.masked_spec_embed" in sd8
    sd8["tl1.positional_encoding.pe"] = torch.from_numpy(sinusoidal_positional_encoding(1024))
    sd8["tl1.feed_forward.layer_norm.weight"] = torch.ones(1024)
    sd8["tl1.feed_forward.layer_norm.bias"] = torch.zeros(1024)
    torch.save({"model_state_dict": sd8, "epoch": 63}, os.path.join(d, files["expr_model_8cl"]))
    sd7 = random_stats_(twins.TwinExprModel("v2", 7, W2V2_LAYERS), seed + 3).state_dict()
    new = f"{POS_CONV}.parametrizations.weight"
    sd7[f"{POS_CONV}.weight_g"] = sd7.pop(f"{new}.original0")
    sd7[f"{POS_CONV}.weight_v"] = sd7.pop(f"{new}.original1")
    torch.save({"model_state_dict": sd7, "epoch": 51}, os.path.join(d, files["expr_model_7cl"]))
    return str(d)


def port_cfg(weights_dir: str, classes: int = 8, quant: str = "none"):
    return port_config.PipelineConfig(
        detector=port_config.DetectorConfig(batch_size=4, long_side=64, transfer_format="bgr",
                                            dtype="float32"),
        visual=port_config.VisualConfig(batch_size=4, dtype="float32", quant=quant),
        audio=port_config.AudioConfig(batch_size=4, dtype="float32", num_classes=classes,
                                      head="v3" if classes == 8 else "v2"),
        weights_dir=weights_dir, save_plot=False)


#: port model family -> (JAX release family, its converter, its keywords)
JAX_FAMILIES = {
    "retinaface": ("retinaface", jax_convert.convert_retinaface, {"backbone": "resnet50"}),
    "emotion_resnet50": ("emotion_resnet50", jax_convert.convert_emotion_resnet50, {}),
    "temporal_lstm": ("temporal_lstm", jax_convert.convert_temporal_lstm, {}),
    "expr_model_8cl": ("expr_model_8cl", jax_convert.convert_expr_model,
                       {"variant": "v3", "num_layers": W2V2_LAYERS}),
    "expr_model_7cl": ("expr_model_7cl", jax_convert.convert_expr_model,
                       {"variant": "v2", "num_layers": W2V2_LAYERS}),
}


def jax_loaded(weights_dir: str, family: str) -> dict:
    """JAX's ``checkpoint.resolve`` of a release file (no orbax cache),
    carried into the port's names by ``core.convert``."""
    fam, converter, kw = JAX_FAMILIES[family]
    variables = jax_checkpoint.resolve(weights_dir, fam, converter, None, (), cache=False, **kw)
    port_family = "expr_model" if fam.startswith("expr_model") else fam
    return convert.CONVERTERS[port_family](jax.tree.map(np.asarray, variables))


def models_of(pipe) -> dict:
    return {"retinaface": pipe.detect.model, "emotion_resnet50": pipe.visual.static_model,
            "temporal_lstm": pipe.visual.lstm_model, "expr_model": pipe.audio.model}


def assert_same_parameters(model: torch.nn.Module, want: dict) -> None:
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    d = write_release_dir(tmp_path_factory.mktemp("release"))
    pipes = {classes: build_pipeline(port_cfg(d, classes), Wav2Vec2Config(num_layers=W2V2_LAYERS),
                                     device="cpu")
             for classes in (8, 7)}
    return d, pipes


@pytest.mark.parametrize("family", list(JAX_FAMILIES))
def test_release_files_load_as_jax_loads_them(release, family):
    """``build_pipeline`` on the release directory loads each family from its
    file, strictly, and every parameter and buffer equals what the JAX
    package's loader makes of the same file: the prefix stripped, the
    wrapper opened, the weight norm fused (both naming schemes) and the keys
    JAX does not read dropped."""
    d, pipes = release
    classes = 7 if family == "expr_model_7cl" else 8
    model = models_of(pipes[classes])["expr_model" if family.startswith("expr") else family]
    assert_same_parameters(model, jax_loaded(d, family))


def test_release_state_dict_drops_encoder_layers_past_num_layers(release, caplog):
    """A head checkpoint deeper than the configured encoder: the JAX
    converter reads the first ``num_layers`` layers, and so does the port,
    logging what it leaves out."""
    d = release[0]
    sd = checkpoint.load_torch_state_dict(os.path.join(d, checkpoint.TORCH_FILES["expr_model_8cl"]))
    want = convert.expr_model(jax.tree.map(np.asarray, jax_convert.convert_expr_model(
        sd, variant="v3", num_layers=1)))
    with caplog.at_level(logging.INFO, logger="avcer_tpu_torch"):
        got = convert.release_state_dict("expr_model", sd, num_layers=1)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    for what in ("encoder layers at or beyond num_layers = 1", "masked_spec_embed",
                 "positional_encoding.pe", "feed_forward.layer_norm"):
        assert what in caplog.text


def test_jax_cache_without_file_raises(tmp_path):
    """Only the JAX package's orbax cache of a family: the port cannot read
    it and refuses by name (ROADMAP's "Not ported": the orbax format),
    instead of serving seeded weights beside it."""
    os.makedirs(tmp_path / "jax" / "temporal_lstm")
    with pytest.raises(NotImplementedError, match='"Not ported": the orbax format'):
        build_pipeline(port_cfg(str(tmp_path)), Wav2Vec2Config(num_layers=W2V2_LAYERS),
                       device="cpu")


def test_file_beside_jax_cache_is_loaded(release, tmp_path, caplog):
    """The release file and the JAX cache of a family: the file is loaded
    and the cache skipped with a log line."""
    d = str(tmp_path)
    shutil.copy(os.path.join(release[0], checkpoint.TORCH_FILES["temporal_lstm"]), d)
    os.makedirs(os.path.join(d, "jax", "temporal_lstm"))
    with caplog.at_level(logging.INFO, logger="avcer_tpu_torch"):
        pipe = build_pipeline(port_cfg(d), Wav2Vec2Config(num_layers=W2V2_LAYERS), device="cpu")
    assert "the JAX cache" in caplog.text and "is skipped" in caplog.text
    assert_same_parameters(pipe.visual.lstm_model, jax_loaded(d, "temporal_lstm"))


def test_unknown_key_raises(release, tmp_path):
    """A key the model does not have fails the strict load."""
    sd = checkpoint.load_torch_state_dict(
        os.path.join(release[0], checkpoint.TORCH_FILES["temporal_lstm"]))
    sd["lstm3.weight_ih_l0"] = torch.zeros(4, 4)
    torch.save(sd, tmp_path / checkpoint.TORCH_FILES["temporal_lstm"])
    with pytest.raises(RuntimeError, match="lstm3.weight_ih_l0"):
        build_pipeline(port_cfg(str(tmp_path)), Wav2Vec2Config(num_layers=W2V2_LAYERS),
                       device="cpu")


def test_int8_with_jax_sidecar_raises(release, tmp_path):
    """The JAX package's int8 calibration sidecar of a family served in
    int8: the port cannot read it, and refuses rather than quantise with
    other scales than JAX's. Served exact, the sidecar does not matter."""
    d = str(tmp_path)
    shutil.copy(os.path.join(release[0], checkpoint.TORCH_FILES["temporal_lstm"]), d)
    os.makedirs(os.path.join(d, "jax", "emotion_resnet50_act_scales"))
    with pytest.raises(NotImplementedError, match="emotion_resnet50_act_scales"):
        build_pipeline(port_cfg(d, quant="int8"), Wav2Vec2Config(num_layers=W2V2_LAYERS),
                       device="cpu")
    assert checkpoint.resolve(d, "emotion_resnet50", int8=False) is None
