"""The port's offline fusion evaluation against the JAX package on the CPU:
the metrics copy, the weight search (candidates, per-candidate metrics,
selection), alignment and fused metrics, the challenge txt, the evaluation
CLI in its five modes over the synthetic trees of
tests/test_eval_offline_cli.py, and the weight plots."""

import builtins
import json
import logging
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from avcer_tpu.cli import eval_offline as jax_cli
from avcer_tpu.fusion import offline_eval as jax_offline
from avcer_tpu.fusion import weight_search as jax_ws
from avcer_tpu.train import metrics as jax_metrics

from avcer_tpu_torch.cli import eval_offline as cli
from avcer_tpu_torch.core import registry
from avcer_tpu_torch.fusion import offline_eval, weight_search
from avcer_tpu_torch.train import metrics

from test_eval_offline_cli import write_caches, write_reference_tree

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# train.metrics (a numpy copy)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_copy_equals_original(seed):
    rng = np.random.default_rng(seed)
    true, pred = rng.integers(0, 7, 200), rng.integers(0, 7, 200)
    true[:5] = 3  # a class present in the labels only
    pred[pred == 5] = 6  # a class never predicted
    np.testing.assert_array_equal(metrics.confusion(true, pred, 7),
                                  jax_metrics.confusion(true, pred, 7))
    for name in ("uar", "macro_f1", "macro_precision"):
        assert getattr(metrics, name)(true, pred) == getattr(jax_metrics, name)(true, pred)
    assert metrics.accuracy(true, pred) == jax_metrics.accuracy(true, pred)
    assert metrics.reference_metrics(true, pred) == jax_metrics.reference_metrics(true, pred)
    assert metrics.fusion_metric(true, pred) == jax_metrics.fusion_metric(true, pred)
    va_t, va_p = rng.normal(size=(50, 2)), rng.normal(size=(50, 2))
    assert metrics.va_score(va_t, va_p) == jax_metrics.va_score(va_t, va_p)


# ---------------------------------------------------------------------------
# weight search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,c,seed", [(50, 3, 7, 42), (7, 2, 5, 1)])
def test_dirichlet_weights_equal_bit_for_bit(n, m, c, seed):
    np.testing.assert_array_equal(weight_search.dirichlet_weights(n, m, c, seed),
                                  jax_ws.dirichlet_weights(n, m, c, seed))


def test_evaluate_candidates_matches_jax():
    """Seeded [3, 300, 7] predictions, 256 Dirichlet candidates. The metrics
    of every candidate whose fused argmax equals JAX's on every frame agree
    within 1e-6 (f32 divisions and a six-term mean in another order). A
    candidate whose argmax flipped on a near-tie (the f32 sum of three
    products in another order) is counted and reported; at most one is
    allowed."""
    rng = np.random.default_rng(0)
    preds = rng.random((3, 300, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 300)
    w = weight_search.dirichlet_weights(256, 3, 7, 42).astype(np.float32)
    want = [np.asarray(x) for x in jax_ws.evaluate_candidates(
        jnp.asarray(preds), jnp.asarray(labels.astype(np.int32)), jnp.asarray(w))]
    pt, wt = torch.from_numpy(preds), torch.from_numpy(w)
    got = [x.numpy() for x in weight_search.evaluate_candidates(pt, torch.from_numpy(labels), wt)]
    jax_cls = np.asarray(jnp.einsum("mnc,wmc->wnc", preds, w,
                                    precision="highest").argmax(-1))
    port_cls = (pt[0][None] * wt[:, 0, None] + pt[1][None] * wt[:, 1, None]
                + pt[2][None] * wt[:, 2, None]).argmax(-1).numpy()
    same = (jax_cls == port_cls).all(axis=1)
    flipped = int((~same).sum())
    print(f"candidates with a flipped near-tie argmax: {flipped} of 256")
    assert flipped <= 1
    for g, want_x in zip(got, want):
        assert g.shape == (256,) and g.dtype == np.float32
        np.testing.assert_allclose(g[same], want_x[same], atol=1e-6, rtol=0)


def test_evaluate_candidates_matches_host_metric():
    """Against train.metrics.fusion_metric on the f64 fused argmax."""
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 7, 150)
    preds = rng.random((3, 150, 7))
    w = rng.random((4, 3, 7))
    uar, f1, prec = weight_search.evaluate_candidates(
        torch.from_numpy(preds.astype(np.float32)), torch.from_numpy(labels),
        torch.from_numpy(w.astype(np.float32)))
    for i in range(4):
        p_, f_, u_ = metrics.fusion_metric(labels, np.einsum("mnc,mc->nc", preds, w[i]).argmax(-1))
        assert abs(float(uar[i]) - u_) < 1e-5
        assert abs(float(f1[i]) - f_) < 1e-5
        assert abs(float(prec[i]) - p_) < 1e-5


def test_search_dirichlet_picks_jax_candidate():
    """The planted optimum of tests/test_datasets_and_misc.py: model 0
    perfect, models 1-2 noise; the same candidate (bit for bit) and UAR,
    also with chunks that split the candidates."""
    rng = np.random.default_rng(0)
    n, c = 300, 7
    labels = rng.integers(0, c, n)
    preds = [np.eye(c)[labels] + rng.normal(0, 0.01, (n, c)), rng.random((n, c)),
             rng.random((n, c))]
    want_w, want_u = jax_ws.search_dirichlet(labels, preds, num_weights=200, seed=42)
    for chunk in (1024, 37):
        got_w, got_u = weight_search.search_dirichlet(labels, preds, num_weights=200, seed=42,
                                                      chunk=chunk, device="cpu")
        np.testing.assert_array_equal(got_w, want_w)
        assert got_u == pytest.approx(want_u, abs=1e-6) and got_u > 0.9


@pytest.mark.parametrize("m", [2, 3])
def test_search_grid_picks_jax_combination(m):
    rng = np.random.default_rng(1)
    n, c = 200, 7
    labels = rng.integers(0, c, n)
    preds = [np.eye(c)[labels]] + [rng.random((n, c)) for _ in range(m - 1)]
    want_combo, want_u = jax_ws.search_grid(labels, preds)
    got_combo, got_u = weight_search.search_grid(labels, preds, device="cpu")
    assert got_combo == want_combo and len(got_combo) == m
    assert got_u == pytest.approx(want_u, abs=1e-6) and got_u > 0.9


def test_search_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is what a machine without CUDA shows")
    with pytest.raises(RuntimeError, match="cuda"):
        weight_search.search_grid(np.zeros(4, np.int64), [np.zeros((4, 7))] * 2)


# ---------------------------------------------------------------------------
# alignment, fused metrics, challenge txt
# ---------------------------------------------------------------------------

def test_align_and_evaluate_fusion_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    t = 40
    labels = rng.integers(0, 7, t)
    labels[3], labels[7] = -1, 7
    stat = jax_offline.np_softmax(rng.normal(size=(t, 7)))
    dyn = rng.normal(size=(t, 7))
    audio = rng.normal(size=(t - 5, 8))  # audio runs short: forward fill
    got = offline_eval.align_video(labels, stat, dyn, audio)
    want = jax_offline.align_video(labels, stat, dyn, audio)
    for key in ("trues", "stat", "dyn", "audio"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    w1 = rng.random((3, 7))
    res = offline_eval.evaluate_fusion(got, w1, (0.5, 1.0, 2.0), corpus="C",
                                       save_root=str(tmp_path / "port"))
    ref = jax_offline.evaluate_fusion(want, w1, (0.5, 1.0, 2.0), corpus="C",
                                      save_root=str(tmp_path / "jax"))
    assert res.keys() == ref.keys()
    for key in res:
        np.testing.assert_array_equal(np.asarray(res[key]), np.asarray(ref[key]))
    for side in ("port", "jax"):
        assert os.path.exists(tmp_path / side / "confusion_matrices" / "C_av_sd_sd.pdf")
    with open(tmp_path / "port" / "metrics_dicts" / "C_metrics_dict_av_sd.pickle", "rb") as fh:
        assert pickle.load(fh)["uar_av"] == ref["uar_av"]
    with pytest.raises(ValueError, match="no rows"):
        offline_eval.align_video(np.array([-1, 3]), stat[:1], dyn[:1], audio[:1])


def test_evaluate_fusion_without_matplotlib(tmp_path, monkeypatch, caplog):
    """No matplotlib (the card's machine): the pickle is written, the pdf is
    skipped with a warning that names matplotlib."""
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    rng = np.random.default_rng(3)
    aligned = offline_eval.AlignedPredictions(rng.integers(0, 7, 20), rng.random((20, 7)),
                                              rng.random((20, 7)), rng.random((20, 7)))
    with caplog.at_level(logging.WARNING, logger="avcer_tpu_torch"):
        offline_eval.evaluate_fusion(aligned, np.ones((3, 7)), save_root=str(tmp_path))
    assert "matplotlib" in caplog.text
    assert os.listdir(tmp_path / "metrics_dicts") == ["corpus_metrics_dict_av_sd.pickle"]
    assert not os.path.exists(tmp_path / "confusion_matrices")


@pytest.mark.parametrize("ce_weights_type,ce_mask", [(False, True), (True, False)])
def test_compound_submission_writes_jax_txt(tmp_path, ce_weights_type, ce_mask):
    rng = np.random.default_rng(4)
    stat = jax_offline.np_softmax(rng.normal(size=(30, 7)))
    dyn, audio = rng.normal(size=(30, 7)), rng.normal(size=(30, 7))
    args = (stat, dyn, audio, "clip", registry.AV_WEIGHTS_8CL, (1.0, 0.5, 2.0),
            ce_weights_type, ce_mask)
    got = offline_eval.compound_submission(*args, str(tmp_path / "port"), device="cpu")
    want = jax_offline.compound_submission(*args, str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want)
    assert open(got).read() == open(want).read()


# ---------------------------------------------------------------------------
# the CLI, five modes, against the JAX CLI
# ---------------------------------------------------------------------------

def last_json(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def all_json(capsys) -> list:
    return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()
            if ln.startswith("{")]


def assert_same(got, want, path="") -> None:
    """Equal structure, strings and integers; floats within 1e-6 (the f32
    metrics of the weight search)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-6), path
    else:
        assert got == want, path


def run_both(capsys, argv) -> tuple[list, list]:
    assert jax_cli.main(argv) == 0
    want = all_json(capsys)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    return all_json(capsys), want


def test_cli_flat_optimize_weights_equals_jax(tmp_path, capsys):
    write_caches(tmp_path, np.random.default_rng(0))
    got, want = run_both(capsys, [
        "--ann_root", str(tmp_path / "ann"), "--preds_root", str(tmp_path / "preds"),
        "--save_root", str(tmp_path / "report"), "--optimize_weights",
        "--num_dirichlet", "300"])
    assert len(got) == len(want) == 2
    assert_same(got, want)
    assert got[1]["uar_av"] > 0.4


def test_cli_flat_reads_the_port_run_tree(tmp_path, capsys):
    """The tree ``avcer_tpu_torch.cli.run`` writes: flat video and audio CSVs
    with the audio__ prefix, a 7-class run's audio under audio_<pad>_<step>/."""
    write_caches(tmp_path, np.random.default_rng(1))
    run = tmp_path / "run"
    os.makedirs(run / "audio_mean_0.5")
    for f in os.listdir(tmp_path / "preds" / "video"):
        os.rename(tmp_path / "preds" / "video" / f, run / f)
    for i, f in enumerate(sorted(os.listdir(tmp_path / "preds" / "audio"))):
        df = pd.read_csv(tmp_path / "preds" / "audio" / f)
        if i == 0:  # a 7-class run
            df.drop(columns=["Other"]).to_csv(run / "audio_mean_0.5" / f"audio__{f}", index=False)
        else:
            df.to_csv(run / f"audio__{f}", index=False)
    got, want = run_both(capsys, ["--ann_root", str(tmp_path / "ann"), "--preds_root",
                                  str(run), "--save_root", str(tmp_path / "report")])
    assert_same(got, want)


def test_cli_reference_layout_equals_jax(tmp_path, capsys):
    write_reference_tree(tmp_path, np.random.default_rng(2))
    got, want = run_both(capsys, [
        "--ann_root", str(tmp_path / "ann"), "--preds_root", str(tmp_path / "preds"),
        "--save_root", str(tmp_path / "report"), "--layout", "reference"])
    assert_same(got, want)


def test_cli_afew_layout_equals_jax(tmp_path, capsys):
    write_reference_tree(tmp_path, np.random.default_rng(3), n_videos=4)
    pd.DataFrame({"name_video": [f"vid{i}.avi" for i in range(4)],
                  "emotion": ["Angry", "Happy", "Neutral", "Sad"]}).to_csv(
        tmp_path / "AFEW_data.csv", index=False)
    got, want = run_both(capsys, [
        "--ann_root", str(tmp_path / "ann"), "--preds_root", str(tmp_path / "preds"),
        "--save_root", str(tmp_path / "report"), "--layout", "reference",
        "--afew_data", str(tmp_path / "AFEW_data.csv"), "--corpus", "AFEW"])
    assert_same(got, want)


def test_cli_audio_sweep_root_equals_jax(tmp_path, capsys):
    model = "7cl-FLW-ExprModelV2-2024.03.04-11.52.11"
    for i, folder in enumerate(("audio_mean_0.5", "audio_repeat_2")):
        write_reference_tree(tmp_path, np.random.default_rng(4 + i), audio_folder=folder,
                             model_name=model)
    got, want = run_both(capsys, ["--ann_root", str(tmp_path / "ann"), "--preds_root",
                                  str(tmp_path / "preds"), "--audio_sweep_root",
                                  str(tmp_path / "preds")])
    assert_same(got, want)
    assert set(got[-1]) == {f"audio_mean_0.5/{model}", f"audio_repeat_2/{model}"}


def test_cli_sweep_audio_dirs_equals_jax(tmp_path, capsys):
    write_caches(tmp_path, np.random.default_rng(6))
    preds = tmp_path / "preds"
    os.rename(preds / "audio", preds / "audio_mean_0.5")
    write_caches(tmp_path, np.random.default_rng(7))  # a second audio dir
    os.rename(preds / "audio", preds / "audio_repeat_0.5")
    got, want = run_both(capsys, ["--ann_root", str(tmp_path / "ann"), "--preds_root",
                                  str(preds), "--sweep_audio_dirs", "audio_mean_0.5",
                                  "audio_repeat_0.5"])
    assert_same(got, want)
    assert set(got[-1]) == {"audio_mean_0.5", "audio_repeat_0.5"}


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal is what a machine without CUDA shows")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--ann_root", str(tmp_path), "--preds_root", str(tmp_path)])


def test_plot_weights_writes_four_pdfs(tmp_path, capsys):
    from avcer_tpu_torch.cli import plot_weights

    assert plot_weights.main(["--out_dir", str(tmp_path), "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["rule2_pair_weights.pdf", "weights_av_7cl.pdf",
                                            "weights_av_8cl.pdf", "weights_video.pdf"]
    assert all(os.path.getsize(tmp_path / f) > 0 for f in os.listdir(tmp_path))
    assert capsys.readouterr().out.strip() == f"wrote weight matrices to {tmp_path}"
