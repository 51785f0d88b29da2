"""The ``wavlm_fused`` configuration's pieces on the CPU: its family's
parameters are the program's state dict at the published widths, its
position bias switch moves the output, and the three readers it adds (K2's
roofline share, the bias share, the encoder's host time) on a synthetic
record, reading nothing where the program records nothing."""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import models as M
from perfbench.tests.test_perfbench_families import program_state_shapes
from perfbench.tests.tiny import ROOT

NEW = ("k2_roofline", "audio.k2_bias_share", "audio.encode_host_ms_per_vs")
#: a WavLM that the CPU runs in a blink, with the published extractor
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
             conv_dim=[16] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def config() -> dict:
    with open(os.path.join(ROOT, "perfbench", "configs", "wavlm_fused.json")) as f:
        return json.load(f)


def reader(name: str):
    return harness.metric_reader(ROOT, name)


def test_family_spec_is_the_programs_state_dict(tmp_path):
    """The names and shapes ``wavlm_expr_v3`` draws at the published shape
    are the state dict of the ExprModel the configuration's argv builds:
    WavLM-Large's 24 layers, the bucket table in layer 0 alone, no conv
    bias."""
    c = config()
    families = M.load_families(c["models"], ROOT)
    built = program_state_shapes(c, str(tmp_path))
    spec = {n: s for n, s, _ in families["audio"].spec()}
    assert spec == built["ExprModel"]
    assert spec["wav2vec2.encoder.layers.0.attention.rel_attn_embed.weight"] == (320, 16)
    assert not any("rel_attn_embed" in n for n in spec if ".layers.0." not in n)
    assert sum(n.endswith("gru_rel_pos_const") for n in spec) == 24
    assert "wav2vec2.feature_extractor.conv_layers.0.conv.bias" not in spec
    assert sum(torch.Size(s).numel() for n, s in spec.items() if n.startswith("wav2vec2.")) \
        == pytest.approx(316e6, rel=0.01)


def test_the_position_bias_moves_the_logits():
    """The family on weights whose relative embedding is zero (g B = 0)
    parts from the family on the same weights with it drawn: the bias
    dropped is a different answer."""
    fam = M.load_families({"audio": {"module": "wavlm_expr_v3", "shape": dict(
        config()["models"]["audio"]["shape"], **SMALL)}}, ROOT)["audio"]
    w = weights.draw(fam.spec(), torch.Generator().manual_seed(9), "cpu")
    table = "wav2vec2.encoder.layers.0.attention.rel_attn_embed.weight"
    dropped = dict(w, **{table: torch.zeros_like(w[table])})
    wav = torch.randn(2, 64000, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = fam.forward(M.Ctx(w), wav), fam.forward(M.Ctx(dropped), wav)
    assert a.shape == (2, 8) and (a - b).abs().max() > 1e-3 * a.abs().max()


def k2_span(i: int, bias: bool, clip=100):
    attrs = dict(bh=256, t=199, d=64, dtype="torch.bfloat16", bias=bias, heads=16,
                 nb=320 if bias else 0)
    return SimpleNamespace(id=i, name="k2", clip=clip, attrs=attrs, seconds=1e-4)


@pytest.fixture
def program(monkeypatch):
    from avcer_tpu_torch.utils import trace

    def use(spans, clips):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
        monkeypatch.setattr(trace, "clips", lambda: list(clips))

    spans = [k2_span(1, True), k2_span(2, True), k2_span(3, False),
             k2_span(4, True, clip=None),  # not a profiled clip's
             SimpleNamespace(id=5, name="audio.encode", clip=100, attrs={}, seconds=0.25),
             SimpleNamespace(id=6, name="audio.encode", clip=None, attrs={}, seconds=9.0)]
    use(spans, [SimpleNamespace(id=100, counts={"k2.calls": 4, "k2.bias_calls": 3})])
    return use


def observation(video_s: float = 4.0):
    """Two K2 kernels of 30 us and 40 us among other device work."""
    device = [(0.0, 30e-6, "void (anonymous namespace)::mha_tc_bias_kernel<13, 4>(x)", 7, 1),
              (1.0, 1.0 + 40e-6, "void (anonymous namespace)::mha_tc_kernel<13, 4>(x)", 7, 2),
              (2.0, 2.5, "void fused_chain_kernel<1>(x)", 7, 3)]
    return SimpleNamespace(profile=SimpleNamespace(video_s=video_s, device=device))


def test_values_on_a_synthetic_record(program):
    from perfbench.work import bound_s

    k2 = reader("k2_roofline")
    biased = k2.k2_work(k2_span(0, True).attrs)
    plain = k2.k2_work(k2_span(0, False).attrs)
    # Q, K, V, O in bf16; the gate, the table and the map in 4 bytes each
    assert plain[0] == 4 * 256 * 199 * 64 * 2
    assert biased[0] == plain[0] + 4 * (256 * 199 + 16 * 320 + 2 * 199 - 1)
    assert biased[1] == {"bf16": 4.0 * 256 * 199 ** 2 * 64, "f32": 2.0 * 256 * 199 ** 2}
    assert bound_s(*biased) == pytest.approx(biased[0] / 3.35e12)  # bytes bind
    got = {name: reader(name).read(observation()) for name in NEW}
    assert got["k2_roofline"] == pytest.approx(
        100 * (2 * bound_s(*biased) + bound_s(*plain)) / 70e-6)
    assert got["audio.k2_bias_share"] == pytest.approx(75.0)
    assert got["audio.encode_host_ms_per_vs"] == pytest.approx(1e3 * 0.25 / 4)


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(name, program):
    program([], [])
    assert reader(name).read(observation()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracer_reads_nothing(name, monkeypatch):
    import avcer_tpu_torch.utils

    monkeypatch.delattr(avcer_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "avcer_tpu_torch.utils.trace", None)
    assert reader(name).read(observation()) is None


@pytest.mark.parametrize("name", NEW)
def test_no_profile_reads_nothing(name, program):
    assert reader(name).read(SimpleNamespace(profile=None)) is None
