"""The plain reference against the port's plain path (the CPU runs the
port's kernels' plain versions) at a small size: each model alone, and a
whole run, set-up to check, in float32."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import program, weights
from perfbench.reference import models as M
from perfbench.tests import tiny
from perfbench.traffic import Traffic


@pytest.mark.parametrize("argv,backbone", [
    (["--serving_profile", "parity", "--fused"], "resnet50"),
    (["--serving_profile", "fast", "--fused"], "mobilenet0.25")])
def test_models_agree_with_the_port(argv, backbone, tmp_path):
    torch.manual_seed(0)
    cfg = program.pipeline_config(dict(argv=argv + ["--long_side", "96"]), str(tmp_path))
    f32 = dict(dtype="float32", quant="none")
    cfg = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, batch_size=8, **f32),
        visual=dataclasses.replace(cfg.visual, batch_size=4, **f32),
        audio=dataclasses.replace(cfg.audio, shared_extractor=False, **f32))
    traffic = Traffic(tiny.MIX, 2 ** 31 + 1)
    w = weights.make(2 ** 31 + 1, program.serving_of(cfg), traffic, "cpu", tiny.W2V)
    pipe = program.build(cfg, weights.to_host(w), "cpu", tiny.wav2vec2_config())

    def close(got, want, tol=1e-4):
        for g, r in zip(got, want):
            assert float((g.float() - r).abs().max()) <= tol * float(r.abs().max())

    with torch.no_grad():
        x = torch.randn(2, 64, 96, 3) * 50
        close(pipe.detect.model(x), M.retinaface(M.Ctx(w["retinaface"]), x, backbone))
        c = torch.randn(2, 224, 224, 3) * 50
        close(pipe.visual.static_model(c), M.emotion_resnet(M.Ctx(w["emotion_resnet50"]), c))
        s = torch.randn(3, 10, 512)
        close([pipe.visual.lstm_model(s)], [M.temporal_lstm(M.Ctx(w["temporal_lstm"]), s)])
        a = torch.randn(2, 64000)
        close([pipe.audio.model(a)], [M.expr_model(M.Ctx(w["expr_model"]), a, tiny.W2V)])


@pytest.mark.parametrize("name,workload", [("parity_fused", "parity_fused.long_clips"),
                                           ("max_fused", "max_fused.short_clips")])
def test_a_whole_run_agrees_in_float32(name, workload, tmp_path):
    """The run's steps on the CPU, the configuration's serving switches
    (stride, the CNN's cadence, the shared extractor, the I420 wire) with
    float32 stages and no int8: every number compared reads rounding."""
    replace = tiny.small(True)

    def exact(cfg):
        cfg = replace(cfg)
        return dataclasses.replace(
            cfg, detector=dataclasses.replace(cfg.detector, quant="none"),
            visual=dataclasses.replace(cfg.visual, quant="none"),
            audio=dataclasses.replace(cfg.audio, quant="none"))

    from perfbench import harness

    run = harness.Run(tiny.cell(name, workload), 2 ** 31 + 7, torch.device("cpu"),
                      str(tmp_path), tiny.wav2vec2_config(), exact)
    run.warm_up()
    run.window(0.5)
    numbers, correct = run.check()
    assert correct
    assert max(numbers.values()) < 1e-4, numbers
