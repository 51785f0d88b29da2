"""The port's release check (``cli.convert_verify``), its calibration sidecar,
its Keras converter and its multi-process simulation, against the JAX
package on the CPU: the report and exit codes on the release layout of
``test_torch_release.write_release_dir`` (scalar counts equal to the JAX
module's), a wrong file giving ``FAIL``, the sidecar's round trip and its
adoption in ``build_pipeline`` (after ``run_calibration`` on a synthetic
clip), the Keras LSTM converter against ``avcer_tpu.core.convert_keras`` on
the same ``.h5`` (atol 1e-4, rtol 1e-3, tests/test_convert_keras.py's), and
``launch_sim`` with 2 processes against one process on the global batch."""

from __future__ import annotations

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avcer_tpu.cli import convert_verify as jax_cv
from avcer_tpu.core import convert_keras as jax_keras
from avcer_tpu.models.temporal_lstm import TemporalLSTM as JaxTemporalLSTM

from avcer_tpu_torch.cli import convert_verify as cv
from avcer_tpu_torch.core import checkpoint, convert_keras
from avcer_tpu_torch.core import config as port_config
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.pipeline.builder import build_pipeline

import torch_twins as twins
from test_convert_keras import write_keras_lstm_h5
from test_torch_release import write_release_dir

torch.set_num_threads(2)

TINY_W2V2 = Wav2Vec2Config(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                           conv_dim=(16,) * 7)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    return write_release_dir(tmp_path_factory.mktemp("release"))


def test_report_and_exit_codes_match_jax(release, capsys):
    """Every family of the release ``ok``, with the JAX module's scalar
    counts (file and converted) and, but for the detector, its status; no
    ``parity`` without a reference tree; the report says that nothing is
    cached; ``main`` exits 0 and prints it. (The JAX module's structure
    check probes ``body.layer4`` without the ``module.`` prefix the release's
    detector file carries, takes the r50 file for mobilenet0.25 and reports
    ``FAIL (structure mismatch)``; the port strips the prefix first.)"""
    events: list[str] = []
    got = cv.verify_weights_dir(release, progress=events.append, device="cpu")
    want = jax_cv.verify_weights_dir(release, cache=False, progress=lambda _s: None)
    assert want["retinaface"]["status"] == "FAIL (structure mismatch)"
    for family in cv.FAMILIES:
        assert got[family]["status"] == "ok", got[family]
        assert family == "retinaface" or want[family]["status"] == "ok", want[family]
        for key in ("torch_scalars", "converted_scalars"):
            assert got[family][key] == want[family][key] > 0, (family, key)
        assert "parity" not in got[family]
    assert got["cache"] == cv.NO_CACHE and len(events) == len(cv.FAMILIES)
    json.dumps(got)
    assert cv.main(["--weights_dir", release, "--families", "temporal_lstm", "--no_cache",
                    "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["temporal_lstm"][
        "status"] == "ok"
    if not torch.cuda.is_available():  # the default device is the card's
        with pytest.raises(RuntimeError, match="cuda"):
            cv.main(["--weights_dir", release])
        with pytest.raises(RuntimeError, match="cuda"):
            cv.verify_weights_dir(release, progress=lambda _s: None)


def test_wrong_file_fails(release, tmp_path, capsys):
    """A dropped tensor fails the structure check, a tensor of another shape
    too, a missing family is ``missing`` (not a failure); ``main`` exits 1
    where a family fails. The JAX module gives the same statuses."""
    name = checkpoint.TORCH_FILES["temporal_lstm"]
    sd = torch.load(os.path.join(release, name), map_location="cpu")
    cases = {"dropped": dict(sd), "reshaped": dict(sd)}
    del cases["dropped"]["fc.bias"]
    cases["reshaped"]["fc.weight"] = torch.zeros(7, 255)
    for what, bad in cases.items():
        d = tmp_path / what
        d.mkdir()
        torch.save(bad, d / name)
        got = cv.verify_weights_dir(str(d), families=["temporal_lstm", "retinaface"],
                                    progress=lambda _s: None, device="cpu")
        want = jax_cv.verify_weights_dir(str(d), families=["temporal_lstm"], cache=False,
                                         progress=lambda _s: None)
        rec = got["temporal_lstm"]
        assert rec["status"].startswith("FAIL"), rec
        assert want["temporal_lstm"]["status"].startswith("FAIL")
        assert got["retinaface"]["status"] == "missing"
        if what == "dropped":
            assert rec["status"] == "FAIL (structure mismatch)"
            assert any("fc.bias" in p for p in rec["structure"])
        assert cv.main(["--weights_dir", str(d), "--families", "temporal_lstm",
                        "--device", "cpu"]) == 1
        capsys.readouterr()


def int8_cfg(weights_dir: str) -> port_config.PipelineConfig:
    return port_config.PipelineConfig(
        detector=port_config.DetectorConfig(batch_size=4, long_side=64, transfer_format="bgr",
                                            dtype="float32", quant="int8"),
        visual=port_config.VisualConfig(batch_size=4, dtype="float32", quant="int8"),
        audio=port_config.AudioConfig(batch_size=4, dtype="float32", quant="int8"),
        weights_dir=weights_dir, save_plot=False)


def test_sidecar_round_trip_and_adoption(tmp_path, caplog):
    """``run_calibration`` on a synthetic clip (``make_clip``) writes the
    three sidecars; they round-trip through ``torch.save`` / ``weights_only``
    load; a later int8 build adopts them (every scale the elementwise max of
    its seeded value and the sidecar's), a sidecar of another structure is
    warned about and skipped, a file that does not load is skipped, and an
    exact build reads none."""
    wdir = str(tmp_path / "weights")
    os.makedirs(wdir)
    video = str(tmp_path / "calib.avi")
    cv.make_clip(video, str(tmp_path / "calib.wav"), seconds=0.4, size=(64, 64))
    rep = cv.run_calibration(wdir, [video], base_cfg=int8_cfg(wdir), wav2vec2_config=TINY_W2V2,
                             progress=lambda *_: None, device="cpu")
    assert rep["status"] == "ok" and rep["frames"] == 10 and rep["audio_windows"] == 1, rep
    assert set(rep["persisted"]) == {"retinaface", "emotion_resnet50", "expr_model_8cl"}
    for family in rep["persisted"]:
        assert os.path.isfile(os.path.join(wdir, "torch", f"{family}_act_scales.pt"))
    assert checkpoint.load_act_scales(wdir, "retinaface_mnet025") is None

    grown = {k: v * 3 for k, v in checkpoint.load_act_scales(wdir, "emotion_resnet50").items()}
    checkpoint.save_act_scales(wdir, "emotion_resnet50", grown)
    back = checkpoint.load_act_scales(wdir, "emotion_resnet50")
    assert set(back) == set(grown) and all(torch.equal(back[k], grown[k]) for k in grown)
    seeded = build_pipeline(int8_cfg(str(tmp_path / "empty")), TINY_W2V2, device="cpu")
    pipe = build_pipeline(int8_cfg(wdir), TINY_W2V2, device="cpu")
    assert pipe.detect._real_calibrated and pipe.visual._real_calibrated
    assert pipe.audio._real_calibrated
    now = layers.act_scales(pipe.visual.static_model)
    before = layers.act_scales(seeded.visual.static_model)
    for k in now:
        assert torch.equal(now[k], torch.maximum(before[k], grown[k])), k
    audio = checkpoint.load_act_scales(wdir, "expr_model_8cl")
    for k, v in layers.act_scales(pipe.audio.model).items():
        assert float(v) >= float(audio[k]), k

    checkpoint.save_act_scales(wdir, "emotion_resnet50", {"no.such.module": torch.tensor(1.0)})
    with open(checkpoint.act_scales_path(wdir, "retinaface"), "wb") as f:
        f.write(b"not a torch file")
    with caplog.at_level(logging.WARNING, logger="avcer_tpu_torch"):
        pipe = build_pipeline(int8_cfg(wdir), TINY_W2V2, device="cpu")
    assert "incompatible" in caplog.text and "does not load" in caplog.text
    assert not pipe.visual._real_calibrated and not pipe.detect._real_calibrated
    exact = dataclasses.replace(int8_cfg(wdir), detector=port_config.DetectorConfig(
        batch_size=4, long_side=64, transfer_format="bgr"))
    exact = dataclasses.replace(exact, visual=dataclasses.replace(exact.visual, quant="none"),
                                audio=dataclasses.replace(exact.audio, quant="none"))
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="avcer_tpu_torch"):
        build_pipeline(exact, TINY_W2V2, device="cpu")
    assert "act_scales" not in caplog.text


def test_keras_converters_match_jax(tmp_path, rng):
    """The Keras LSTM ``.h5`` of tests/test_convert_keras.py through the
    port's converter into ``TemporalLSTM`` (a strict load) against the JAX
    converter and model and the torch twin, atol 1e-4 and rtol 1e-3; the
    backbone reader's variable tree equals the JAX converter's on an ``.h5``
    holding the feature head."""
    import h5py

    torch.manual_seed(1)
    tw = twins.TwinTemporalLSTM(7).eval()
    path = str(tmp_path / "lstm.h5")
    write_keras_lstm_h5(path, tw)
    model = TemporalLSTM(7)
    model.load_state_dict(convert_keras.convert_keras_lstm(path), strict=True)
    assert not model.lstm1.bias_hh_l0.any()
    x = rng.normal(size=(2, 10, 512)).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
        twin = tw(torch.from_numpy(x)).numpy()
    want = jax.jit(JaxTemporalLSTM(7, dtype=jnp.float32).apply)(
        jax_keras.convert_keras_lstm(path), jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got, twin, atol=1e-4, rtol=1e-3)

    head = str(tmp_path / "head.h5")
    with h5py.File(head, "w") as f:
        for lname, shape in (("features", (2048, 512)), ("dense", (512, 7))):
            g = f.create_group(lname)
            names = [f"{lname}/kernel:0", f"{lname}/bias:0"]
            g.attrs["weight_names"] = [n.encode() for n in names]
            g.create_dataset(names[0], data=rng.normal(size=shape).astype(np.float32))
            g.create_dataset(names[1], data=rng.normal(size=shape[1:]).astype(np.float32))
        f.attrs["layer_names"] = [b"features", b"dense"]
    jax.tree.map(np.testing.assert_array_equal, convert_keras.keras_backbone_variables(head),
                 jax_keras.convert_keras_backbone(head))


def test_launch_sim_two_processes(capsys):
    """``launch_sim`` with 2 processes over gloo: both exit 0, their losses
    agree (checked by the launcher), and the first step's loss equals one
    process's over the global batch on the same (data 4, model 2) mesh of 8
    CPU devices, bf16 compute (rtol 1e-3: the BatchNorm sums and the
    gradient all-reduce add in another order)."""
    from avcer_tpu_torch.core.config import MeshConfig, OptimConfig, TrainConfig
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.parallel import distributed, launch_sim
    from avcer_tpu_torch.train.trainer import Trainer

    assert launch_sim.main(["--processes", "2"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] and summary["local_samples"] == [12, 12]
    rng = np.random.default_rng(0)
    wavs = rng.normal(size=(24, 17600)).astype(np.float32) * 0.1
    labels = rng.integers(0, 8, 24)
    idx = np.concatenate([distributed.FileShardedSampler(
        24, lambda i: f"file_{i // 4}", local_batch=4, process_index=p, process_count=2,
        seed=0).epoch(0)[0] for p in range(2)])
    cfg = TrainConfig(batch_size=8, mesh=MeshConfig(data=4, model=2), optim=OptimConfig(lr=1e-3),
                      log_root="unused")
    tr = Trainer(ExprModel("v3", 8, TINY_W2V2), cfg, iters_per_epoch=2, unfreeze_last_n=1,
                 wav2vec2_layers=2, device="cpu", devices=["cpu"] * 8, dtype="bfloat16")
    _, loss, _ = tr.train_step(tr.init_state(), wavs[idx], labels[idx])
    np.testing.assert_allclose(summary["losses"][0], loss, rtol=1e-3)
