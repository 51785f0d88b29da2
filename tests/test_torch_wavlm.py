"""The port's WavLM encoder (``avcer_tpu_torch.models.wavlm``) on the CPU:
against Hugging Face's ``WavLMModel`` (the oracle) and against the
benchmark's plain family ``wavlm_expr_v3`` at a tiny size, its bucket map
against the oracle's, K2's plain bias mode against an explicit [B, H, T, T]
bias, and the ``--audio_encoder`` choice from the CLI to the audio stage."""

import os
import sys

import numpy as np
import pytest
import torch

from avcer_tpu_torch.cli import run as cli
from avcer_tpu_torch.core.config import AudioConfig
from avcer_tpu_torch.models.audio_heads import ENCODERS, ExprModel
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.models.wavlm import WavLMConfig, WavLMModel, relative_buckets
from avcer_tpu_torch.ops.cuda.attention_kernel import mha_plain
from avcer_tpu_torch.pipeline.audio_stage import AudioStage
from avcer_tpu_torch.pipeline.runner import check_supported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: hidden 64, 4 heads, 3 layers, a 1-channel extractor of three convs, the
#: published buckets and distance
TINY = dict(hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128,
            conv_dim=(32, 32, 32), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
            conv_bias=False, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            num_buckets=320, max_bucket_distance=800)
#: 4000 samples through the tiny extractor: 199 frames, as a 4 s window
#: through the published one
SAMPLES = 4000


def import_transformers():
    """``transformers`` (skips without it), imported with its TensorFlow and
    Flax back ends off: only its torch models are read, and TensorFlow's
    import alone takes some seconds."""
    if "transformers" in sys.modules:
        return sys.modules["transformers"]
    saved = {k: os.environ.get(k) for k in ("USE_TF", "USE_FLAX")}
    os.environ.update(USE_TF="0", USE_FLAX="0")
    try:
        return pytest.importorskip("transformers")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def hf_model():
    """The oracle at ``TINY`` with seeded weights (every parameter drawn, the
    gate's constants and the bucket table included), in eval."""
    transformers = import_transformers()
    c = transformers.WavLMConfig(
        hidden_size=TINY["hidden_size"], num_hidden_layers=TINY["num_layers"],
        num_attention_heads=TINY["num_heads"], intermediate_size=TINY["intermediate_size"],
        conv_dim=TINY["conv_dim"], conv_stride=TINY["conv_stride"],
        conv_kernel=TINY["conv_kernel"], conv_bias=TINY["conv_bias"],
        num_conv_pos_embeddings=TINY["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=TINY["num_conv_pos_embedding_groups"],
        do_stable_layer_norm=True, feat_extract_norm="layer", num_buckets=TINY["num_buckets"],
        max_bucket_distance=TINY["max_bucket_distance"], hidden_act="gelu",
        feat_extract_activation="gelu", layer_norm_eps=1e-5, hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0)
    model = transformers.WavLMModel(c).eval()
    gen = torch.Generator().manual_seed(24)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=gen)
            if name.endswith("rel_attn_embed.weight"):
                p.copy_(0.5 * z)  # a bias that moves the logits
            elif name.endswith("gru_rel_pos_const") or "norm.weight" in name:
                p.copy_(1.0 + 0.2 * z)
            elif p.dim() == 1:
                p.copy_(0.1 * z)
            else:
                p.copy_(z / max(p[0].numel(), 1) ** 0.5)
    return model


def port_state(hf) -> dict:
    """HF's parameters by the port's names: the same, but the positional
    conv's weight norm fused into ``conv.weight``."""
    sd = hf.state_dict()
    out = {}
    for name in WavLMModel(WavLMConfig(**TINY)).state_dict():
        out[name] = (hf.encoder.pos_conv_embed.conv.weight.detach()
                     if name == "encoder.pos_conv_embed.conv.weight" else sd[name])
    return out


def test_wavlm_matches_transformers():
    """The port's encoder against ``WavLMModel`` on the same weights, in
    float32. Both compute the same products in another order (the oracle's
    attention is ``scaled_dot_product_attention`` with the bias as its mask):
    over three layers the hidden states part by about 1e-6 of their scale."""
    hf = hf_model()
    port = WavLMModel(WavLMConfig(**TINY)).eval()
    port.load_state_dict(port_state(hf), strict=True)
    wav = torch.from_numpy(np.random.default_rng(0).normal(size=(2, SAMPLES))
                           .astype(np.float32))
    with torch.no_grad():
        want = hf(wav).last_hidden_state
        got = port(wav)
    assert got.shape == want.shape == (2, 199, TINY["hidden_size"])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # the bias moves the result: the same weights with its table zeroed do not match
    with torch.no_grad():
        port.encoder.layers[0].attention.rel_attn_embed.weight.zero_()
        assert (port(wav) - want).abs().max() > 1e-2


def test_relative_buckets_match_transformers():
    """The bucket map against the oracle's ``_relative_positions_bucket`` at
    every length T = 1-1024 (a bucket depends on j - i alone), and the [H,
    T, T] bias the oracle builds (``compute_bias``) at a few lengths."""
    hf = hf_model()
    attn = hf.encoder.layers[0].attention
    rel = torch.arange(-1023, 1024)
    want = attn._relative_positions_bucket(rel)
    for t in range(1, 1025):
        got = relative_buckets(t, TINY["num_buckets"], TINY["max_bucket_distance"])
        assert got.dtype == torch.int32 and got.shape == (2 * t - 1,)
        assert torch.equal(got.long(), want[1023 - (t - 1):1023 + t]), t
    table = attn.rel_attn_embed.weight.detach().t().contiguous()
    for t in (1, 80, 199, 1024):
        b = relative_buckets(t, TINY["num_buckets"], TINY["max_bucket_distance"])
        pos = torch.arange(t)
        got = table[:, b.long()][:, pos[None, :] - pos[:, None] + t - 1]
        torch.testing.assert_close(got, attn.compute_bias(t, t).detach(), atol=0, rtol=0)


def test_mha_plain_bias_equals_an_explicit_bias():
    """``mha_plain`` with a bias against the softmax of the logits with an
    explicit [B, H, T, T] ``gate * table[h, bucket(j - i)]`` added."""
    rng = np.random.default_rng(3)
    b, h, t, d = 2, 3, 37, 16
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32))
               for _ in range(3))
    table = torch.from_numpy(rng.normal(size=(h, 320)).astype(np.float32))
    buckets = relative_buckets(t, 320, 800)
    gate = torch.from_numpy(rng.uniform(1, 3, size=(b * h, t)).astype(np.float32))
    explicit = torch.empty(b, h, t, t)
    for bi in range(b):
        for hi in range(h):
            for i in range(t):
                for j in range(t):
                    explicit[bi, hi, i, j] = (gate[bi * h + hi, i]
                                              * table[hi, buckets[j - i + t - 1]])
    logits = q @ k.transpose(-1, -2) / 4.0 + explicit
    want = torch.softmax(logits, -1) @ v
    got = mha_plain(q, k, v, (table, buckets, gate))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert (got - mha_plain(q, k, v)).abs().max() > 1e-2


def test_expr_model_matches_the_family_reference():
    """The port's ExprModel V3 on WavLM's structure at ``TINY`` against the
    benchmark's plain ``wavlm_expr_v3`` family, the weights drawn from the
    family's own spec and loaded strictly (the names and shapes are the
    program's). Both in float32; they part by float32 rounding."""
    from perfbench import weights
    from perfbench.reference import models as M

    shape = dict({k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
                 layer_norm_eps=1e-5, num_classes=8, head_heads=[32, 16])
    fam = M.load_families({"audio": {"module": "wavlm_expr_v3", "shape": shape}}, ROOT)["audio"]
    w = weights.draw(fam.spec(), torch.Generator().manual_seed(5), "cpu")
    model = ExprModel("v3", 8, WavLMConfig(**TINY)).eval()
    model.load_state_dict(w, strict=True)
    wav = torch.from_numpy(np.random.default_rng(1).normal(size=(3, SAMPLES))
                           .astype(np.float32))
    with torch.no_grad():
        got = model(wav)
        want = fam.forward(M.Ctx(w), wav)
    assert got.shape == want.shape == (3, 8)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_audio_encoder_from_the_cli_to_the_stage():
    """``--audio_encoder`` reaches ``AudioConfig.encoder`` (default wav2vec2,
    the JAX package's); ``ENCODERS``' configuration of each name; the quantised
    profiles refuse WavLM; the audio stage names the encoder of the model it
    was given."""
    default = cli.config_from_args(cli.parse_args(["--serving_profile", "parity"]))
    assert default.audio.encoder == "wav2vec2-large-robust-12"
    cfg = cli.config_from_args(cli.parse_args(["--serving_profile", "parity", "--fused",
                                               "--audio_encoder", "wavlm-large"]))
    assert cfg.audio.encoder == "wavlm-large"
    check_supported(cfg)
    assert ENCODERS[default.audio.encoder]() == Wav2Vec2Config()
    assert ENCODERS["wavlm-large"]() == WavLMConfig() and WavLMConfig().num_layers == 24
    for profile in ("int8", "fast", "turbo", "max"):
        quantised = cli.config_from_args(cli.parse_args(
            ["--serving_profile", profile, "--audio_encoder", "wavlm-large"]))
        with pytest.raises(ValueError, match="wavlm-large"):
            check_supported(quantised)
    with pytest.raises(SystemExit):
        cli.parse_args(["--audio_encoder", "hubert"])
    small = dict(hidden_size=64, num_layers=1, num_heads=4, intermediate_size=128,
                 conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    for name, config in ENCODERS.items():
        stage = AudioStage(ExprModel("v3", 8, config(**small)),
                           AudioConfig(dtype="float32", encoder=name), device="cpu")
        assert stage.encoder == name
