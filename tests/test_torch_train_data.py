"""The training slice's host side against the JAX package's on the CPU: the
copied modules (``utils.rounding``, ``utils.tb``, ``train.data.windowing``,
``train.data.fe_dataset``, ``train.data.datasets``, ``train.augment``),
pinned by their code (the same syntax tree but for the docstrings and the
package name in imports) and by their outputs (datasets over fabricated ABAW
and MELD layouts, TensorBoard records byte for byte); the detector's anchor
matching and multibox loss; the three training CLIs' argument surface and
refusals; and ``train_visual --model dynamic`` end to end."""

from __future__ import annotations

import ast
import importlib
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from avcer_tpu_torch.pipeline.media import write_wav

COPIES = ["utils.rounding", "utils.tb", "train.data.windowing", "train.data.fe_dataset",
          "train.data.datasets", "train.augment"]


def _code(module_name: str) -> str:
    """The module's syntax tree without docstrings, the package name in its
    imports written as the JAX package's."""
    mod = importlib.import_module(module_name)
    tree = ast.parse(open(mod.__file__).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("avcer_tpu_torch", "avcer_tpu")
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIES)
def test_copy_has_the_original_code(name):
    assert _code(f"avcer_tpu_torch.{name}") == _code(f"avcer_tpu.{name}")


def test_rounding_copy_outputs():
    from avcer_tpu.utils import rounding as want
    from avcer_tpu_torch.utils import rounding as got

    for v in [0.5, 1.5, 2.4999, -0.5, -1.5, -2.6, 29.97, 24.0, 0.0, 7.5000001]:
        assert got.round_math(v) == want.round_math(v)
    rng = np.random.default_rng(1)
    pred = rng.random((12, 7))
    names = [f"f{i % 3}" for i in range(12)]
    targets = list(rng.integers(0, 7, 12))
    a, b = got.majority_voting(targets, pred, names), want.majority_voting(targets, pred, names)
    assert a[0] == b[0] and a[2] == b[2] and all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert got.array_to_bytes(pred) == want.array_to_bytes(pred)
    assert np.array_equal(got.bytes_to_array(want.array_to_bytes(pred)), pred)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowing_and_fe_copies_outputs(seed):
    from avcer_tpu.train.data import fe_dataset as fe_want
    from avcer_tpu.train.data import windowing as want
    from avcer_tpu_torch.train.data import fe_dataset as fe_got
    from avcer_tpu_torch.train.data import windowing as got

    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(np.arange(1, 700), size=500, replace=False))
    labels = rng.integers(-1, 9, 500)
    mouth = rng.integers(0, 2, 500)
    fr = [24.0, 25.0, 29.97][seed]
    assert np.array_equal(got.filter_mouth_closed(ids, labels, mouth, fr),
                          want.filter_mouth_closed(ids, labels, mouth, fr))
    assert got.make_windows("f.txt", ids, labels, fr) == \
        [got.Window(**w.__dict__) for w in want.make_windows("f.txt", ids, labels, fr)]
    segs = [(0, 80000), (90000, 100000), (120000, 250000)]
    assert [w.__dict__ for w in got.windows_from_segments("a.wav", segs, 16000, 3)] == \
        [w.__dict__ for w in want.windows_from_segments("a.wav", segs, 16000, 3)]
    wav = rng.normal(size=1000).astype(np.float32)
    assert np.array_equal(got.pad_window_constant(wav, 1500), want.pad_window_constant(wav, 1500))
    full, fe_labels = np.arange(1, 401), np.abs(labels[:400]) % 8
    a = fe_got.make_fe_windows("v.txt", full, fe_labels, mouth[:400], fr)
    b = fe_want.make_fe_windows("v.txt", full, fe_labels, mouth[:400], fr)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.filename, x.start_t, x.end_t, x.start_f, x.end_f, x.label) == \
            (y.filename, y.start_t, y.end_t, y.start_f, y.end_f, y.label)
        assert np.array_equal(x.mouth_open, y.mouth_open)
        assert np.array_equal(x.downsampled_labels, y.downsampled_labels)
    assert fe_got.downsample_indices(fr, 4.0) == fe_want.downsample_indices(fr, 4.0)


def write_corpus(root: str, rng: np.random.Generator, videos: int = 2, frames: int = 400,
                 utterances: int = 3, seconds: float = 7.0, sr: int = 16000) -> dict:
    """A seeded ABAW-EXPR + MELD layout as the loaders read it (labels txt
    with a header, mouth-open csv, 16 kHz wavs; MELD labels csv, VAD pickle,
    wavs). Returns the paths, in the training config's keys."""
    paths = {k: os.path.join(root, k) for k in ("abaw_wav", "abaw_labels", "abaw_feats",
                                                "meld_wav")}
    for d in paths.values():
        os.makedirs(d, exist_ok=True)
    for v in range(videos):
        n = frames + 50 * v
        labels = rng.integers(0, 8, n)
        labels[rng.integers(0, n, 5)] = -1
        with open(os.path.join(paths["abaw_labels"], f"video{v}.txt"), "w") as f:
            f.write("Neutral,Anger,Disgust,Fear,Happiness,Sadness,Surprise,Other\n")
            f.write("\n".join(str(int(x)) for x in labels) + "\n")
        mouth = (rng.random(n) > 0.2).astype(int)
        pd.DataFrame({"feat_id": np.arange(n), "frame": np.arange(1, n + 1),
                      "surface_area_mouth": rng.random(n), "mouth_open": mouth}).to_csv(
            os.path.join(paths["abaw_feats"], f"video{v}.csv"), index=False)
        write_wav(os.path.join(paths["abaw_wav"], f"video{v}.wav"),
                  (rng.normal(size=int(n / 25 * sr) + sr) * 0.1).astype(np.float32), sr)
    emotions = ["neutral", "anger", "disgust", "fear", "joy", "sadness", "surprise"]
    rows, vad = [], {}
    for u in range(utterances):
        fn = f"dia{u}_utt{u + 1}.wav"
        rows.append({"Dialogue_ID": u, "Utterance_ID": u + 1, "Emotion": emotions[u % 7]})
        n = int(seconds * sr)
        write_wav(os.path.join(paths["meld_wav"], fn),
                  (rng.normal(size=n) * 0.1).astype(np.float32), sr)
        vad[fn] = [{"start": int(0.2 * sr), "end": n - int(0.3 * sr)}]
    pd.DataFrame(rows).to_csv(os.path.join(root, "meld.csv"), index=False)
    with open(os.path.join(root, "vad.pickle"), "wb") as f:
        pickle.dump(vad, f)
    return {"ABAW_WAV_ROOT": paths["abaw_wav"], "ABAW_FILTERED_WAV_ROOT": paths["abaw_wav"],
            "ABAW_LABELS_ROOT": paths["abaw_labels"], "ABAW_FEATURES_ROOT": paths["abaw_feats"],
            "MELD_WAV_ROOT": paths["meld_wav"], "MELD_LABELS_PATH": os.path.join(root, "meld.csv"),
            "MELD_VAD_PATH": os.path.join(root, "vad.pickle")}


def test_datasets_copy_over_fabricated_corpora(tmp_path, rng):
    """ABAW and MELD windows, class weights, ``get`` with and without the
    augmentation, and every ``BatchLoader`` batch equal to the JAX
    package's."""
    from avcer_tpu.train import augment as aug_want
    from avcer_tpu.train.data import datasets as want
    from avcer_tpu_torch.train import augment as aug_got
    from avcer_tpu_torch.train.data import datasets as got

    c = write_corpus(str(tmp_path), rng)
    info = lambda name: (25.0, 0)  # noqa: E731  (fps, frames): no video files here

    def both(mod, aug):
        abaw = mod.load_abaw_expr(c["ABAW_WAV_ROOT"], c["ABAW_LABELS_ROOT"],
                                  c["ABAW_FEATURES_ROOT"], video_info=info,
                                  transform=aug.default_train_augmentation())
        meld = mod.load_meld(c["MELD_WAV_ROOT"], c["MELD_LABELS_PATH"], c["MELD_VAD_PATH"],
                             transform=aug.default_train_augmentation())
        return abaw, meld, mod.concat_datasets([abaw, meld])

    ga, gm, gc = both(got, aug_got)
    wa, wm, wc = both(want, aug_want)
    assert [w.__dict__ for w in ga.windows] == [w.__dict__ for w in wa.windows]
    assert [w.__dict__ for w in gm.windows] == [w.__dict__ for w in wm.windows]
    assert len(gc) == len(wc) > 20
    assert np.array_equal(gc.class_weights(8), wc.class_weights(8))
    for i in (0, len(ga.windows) - 1, len(ga.windows), len(gc) - 1):
        x, y = gc.get(i), wc.get(i)
        assert np.array_equal(x[0], y[0]) and x[1] == y[1]
        x = gc.get(i, np.random.default_rng(i))
        y = wc.get(i, np.random.default_rng(i))
        assert np.array_equal(x[0], y[0]) and x[1] == y[1]
    lg, lw = got.BatchLoader(gc, batch_size=8, seed=3), want.BatchLoader(wc, batch_size=8, seed=3)
    assert len(lg) == len(lw)
    for _ in range(2):  # two epochs: the loaders reshuffle by epoch
        for (xg, yg), (xw, yw) in zip(lg, lw):
            assert np.array_equal(xg, xw) and np.array_equal(yg, yw)


def test_augment_copy_outputs():
    from avcer_tpu.train import augment as want
    from avcer_tpu_torch.train import augment as got

    wav = np.random.default_rng(4).normal(size=3200).astype(np.float32)
    for name in ("identity", "polarity_inversion"):
        assert np.array_equal(getattr(got, name)(wav, None), getattr(want, name)(wav, None))
    for make in ("white_noise", "gain", "default_train_augmentation"):
        for seed in range(4):
            a = getattr(got, make)()(wav, np.random.default_rng(seed))
            b = getattr(want, make)()(wav, np.random.default_rng(seed))
            assert np.array_equal(a, b), (make, seed)
    assert np.array_equal(got.resample(wav, 32000, 16000), want.resample(wav, 32000, 16000))
    effects = [["gain", "-3"], ["speed", "1.1"], ["reverse"], ["norm", "-1"]]
    assert np.array_equal(got.sox_effect(effects)(wav, None), want.sox_effect(effects)(wav, None))


def test_tb_records_byte_for_byte(tmp_path):
    """The event records of the copy equal the original's byte for byte (a
    fixed wall time), and a writer's file holds the version record and the
    scalars in the same framing."""
    from avcer_tpu.utils import tb as want
    from avcer_tpu_torch.utils import tb as got

    for tag, value, step in [("loss", 0.25, 0), ("f1", 0.3333, 7), ("uar", 1e-9, 123456)]:
        assert got.scalar_event(tag, value, step, 1.5e9) == want.scalar_event(tag, value, step, 1.5e9)
        payload = want.scalar_event(tag, value, step, 1.5e9)
        assert got._record(payload) == want._record(payload)
    assert got.crc32c(b"123456789") == want.crc32c(b"123456789") == 0xE3069283
    w = got.SummaryWriter(str(tmp_path / "g"))
    w.add_scalar("loss", 0.5, 3)
    w.close()
    (path,) = list((tmp_path / "g").iterdir())
    data = path.read_bytes()
    n = int.from_bytes(data[:8], "little")
    assert data[8:12] == int.to_bytes(want._masked_crc(data[:8]), 4, "little")
    assert b"brain.Event:2" in data[12:12 + n]
    assert data.endswith(int.to_bytes(want._masked_crc(data[-4 - len(
        want.scalar_event("loss", 0.5, 3, 0.0)):-4]), 4, "little"))


# ---------------------------------------------------------------------------
# detector training: matching and the multibox loss
# ---------------------------------------------------------------------------


def test_match_anchors_and_render_match_jax(rng):
    from avcer_tpu.train import detection as want
    from avcer_tpu_torch.ops import boxes
    from avcer_tpu_torch.train import detection as got

    priors = boxes.prior_boxes((128, 128))
    for seed in range(3):
        img_g, bx_g = got.render_face_scene(np.random.default_rng(seed), (128, 128), [16, 40, 90])
        img_w, bx_w = want.render_face_scene(np.random.default_rng(seed), (128, 128), [16, 40, 90])
        assert np.array_equal(img_g, img_w) and np.array_equal(bx_g, bx_w)
        for truths in (bx_g / 128.0, np.zeros((0, 4), np.float32),
                       np.array([[0.0, 0.0, 0.01, 0.01]], np.float32)):
            (lg, cg), (lw, cw) = got.match_anchors(truths, priors), want.match_anchors(truths, priors)
            assert np.array_equal(lg, lw) and np.array_equal(cg, cw)
    m = np.array([[0.1, 0.1, 0.3, 0.4]], np.float32).repeat(len(priors), 0)
    assert np.array_equal(got.encode_boxes_np(m, priors), want.encode_boxes_np(m, priors))


def test_multibox_loss_matches_jax(rng):
    """Smooth-L1 plus CE with 7:1 hard-negative mining, rtol 1e-5, also with
    tied background losses and a batch row without positives; its gradient
    is finite."""
    from avcer_tpu.train import detection as want
    from avcer_tpu_torch.train import detection as got

    b, a = 3, 200
    loc = rng.normal(size=(b, a, 4)).astype(np.float32)
    conf = rng.normal(size=(b, a, 2)).astype(np.float32)
    conf[1, 50:80] = 0.0  # ties among the negatives
    loc_t = rng.normal(size=(b, a, 4)).astype(np.float32)
    conf_t = (rng.random((b, a)) < 0.05).astype(np.int32)
    conf_t[2] = 0
    w = float(want.multibox_loss(jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(loc_t),
                                 jnp.asarray(conf_t)))
    lt = torch.from_numpy(loc).requires_grad_(True)
    g = got.multibox_loss(lt, torch.from_numpy(conf), torch.from_numpy(loc_t),
                          torch.from_numpy(conf_t))
    np.testing.assert_allclose(float(g.detach()), w, rtol=1e-5)
    g.backward()
    assert torch.isfinite(lt.grad).all()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_audio_cli_surface(tmp_path, capsys):
    """The JAX CLI's flags and config template; ``--compile_cache_dir`` and
    DATA_PARALLEL / MODEL_PARALLEL above 1 refused by name; the card by
    default, which raises without CUDA rather than train on the CPU."""
    from avcer_tpu.cli import train_audio as jax_cli
    from avcer_tpu_torch.cli import train_audio as cli

    a = cli.parse_args(["--config", "c.json", "--epochs", "3", "--resume"])
    assert (a.config, a.epochs, a.resume, a.compile_cache_dir, a.device) == \
        ("c.json", 3, True, "", "cuda")
    assert cli.example_config() == jax_cli.example_config()
    assert cli.main(["--print_example_config"]) == 0
    assert json.loads(capsys.readouterr().out) == jax_cli.example_config()
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["--config", "c.json", "--compile_cache_dir", "X"])
    assert e.value.code == 2
    assert "Not ported" in capsys.readouterr().err
    for key in ("DATA_PARALLEL", "MODEL_PARALLEL"):
        cfg = dict(cli.example_config(), **{key: 2})
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps(cfg))
        with pytest.raises(SystemExit, match="queue 1, parallelism"):
            cli.main(["--config", str(path)])
    if not torch.cuda.is_available():
        c = write_corpus(str(tmp_path / "corpus"), np.random.default_rng(0), videos=1,
                         utterances=1)
        os.makedirs(tmp_path / "videos")
        cfg = dict(cli.example_config(), **c, ABAW_VIDEO_ROOT=str(tmp_path / "videos"),
                   LOGS_ROOT=str(tmp_path / "logs"))
        (tmp_path / "c.json").write_text(json.dumps(cfg))
        import cv2

        out = cv2.VideoWriter(str(tmp_path / "videos" / "video0.avi"),
                              cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (32, 32))
        out.write(np.zeros((32, 32, 3), np.uint8))
        out.release()
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--config", str(tmp_path / "c.json")])


def test_train_visual_cli_surface(tmp_path, capsys):
    """The JAX CLI's flags and defaults; ``--data_parallel`` above 1 refused
    naming ROADMAP queue 1, parallelism; the folder listing, windowing and
    crop batches equal the JAX CLI's."""
    import cv2

    from avcer_tpu.cli import train_visual as jax_cli
    from avcer_tpu_torch.cli import train_visual as cli

    a = cli.parse_args(["--data_root", "d"])
    assert (a.model, a.epochs, a.batch_size, a.lr, a.log_root, a.data_parallel, a.device) == \
        ("static", 10, 64, 1e-4, "logs/visual", 1, "cuda")
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["--data_root", "d", "--data_parallel", "2"])
    assert e.value.code == 2 and "queue 1, parallelism" in capsys.readouterr().err
    rng = np.random.default_rng(2)
    for cls in (0, 3):
        os.makedirs(tmp_path / "crops" / str(cls))
        for i in range(3):
            cv2.imwrite(str(tmp_path / "crops" / str(cls) / f"{i}.jpg"),
                        rng.integers(0, 255, (50, 40, 3), np.uint8))
    os.makedirs(tmp_path / "crops" / "notes")
    items = cli.iter_image_folder(str(tmp_path / "crops"))
    assert items == jax_cli.iter_image_folder(str(tmp_path / "crops")) and len(items) == 6
    for (xg, yg), (xw, yw) in zip(cli.CropLoader(items, 4), jax_cli.CropLoader(items, 4)):
        assert np.array_equal(xg, xw) and np.array_equal(yg, yw) and xg.shape == (4, 224, 224, 3)
    feats = rng.normal(size=(23, 8)).astype(np.float32)
    assert np.array_equal(cli.window_sequences(feats), jax_cli.window_sequences(feats))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--data_root", str(tmp_path / "crops"), "--epochs", "1"])


def test_extract_features_cli_surface(tmp_path, capsys):
    """``--checkpoint`` a directory (a JAX orbax checkpoint) is refused by
    name; ``regroup_by_filename`` equals the JAX CLI's."""
    from avcer_tpu.cli import extract_features as jax_cli
    from avcer_tpu.train.data.windowing import Window
    from avcer_tpu_torch.cli import extract_features as cli

    a = cli.parse_args(["--config", "c", "--checkpoint", "w.pth", "--out", "o.pkl"])
    assert (a.variant, a.num_classes, a.device) == ("v3", 8, "cuda")
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["--config", "c", "--checkpoint", str(tmp_path), "--out", "o"])
    assert e.value.code == 2 and "item 10" in capsys.readouterr().err
    rng = np.random.default_rng(5)
    windows = [Window(f"f{i % 2}.txt", i * 2.0, i * 2.0 + 4, i * 50, i * 50 + 100, i % 8)
               for i in range(5)]
    logits, feats = rng.normal(size=(5, 8)), rng.normal(size=(5, 16))
    targets = np.arange(5)
    got = cli.regroup_by_filename(windows, logits, feats, targets)
    want = jax_cli.regroup_by_filename(windows, logits, feats, targets)
    assert got.keys() == want.keys()
    for k in got:
        for kk in got[k]:
            assert np.array_equal(got[k][kk], want[k][kk]), (k, kk)


def test_train_visual_dynamic_end_to_end(tmp_path):
    """``train_visual --model dynamic --device cpu`` on seeded .npz features:
    two epochs, stats.csv, the best export loading strictly into the
    TemporalLSTM, and the ``latest`` checkpoint."""
    from avcer_tpu_torch.cli import train_visual as cli
    from avcer_tpu_torch.core import checkpoint
    from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM

    rng = np.random.default_rng(6)
    for i in range(2):
        np.savez(tmp_path / f"vid{i}.npz", features=rng.normal(size=(40, 512)).astype(np.float32),
                 labels=rng.integers(0, 7, 40))
    logs = tmp_path / "logs"
    assert cli.main(["--data_root", str(tmp_path), "--model", "dynamic", "--epochs", "2",
                     "--batch_size", "8", "--log_root", str(logs), "--device", "cpu"]) == 0
    stats = pd.read_csv(logs / "run" / "stats.csv")
    assert stats["epoch"].tolist() == [0, 1] and np.isfinite(stats["loss"]).all()
    TemporalLSTM(7).load_state_dict(checkpoint.load_torch_state_dict(
        str(logs / "best_dynamic.pth")), strict=True)
    assert (logs / "run" / "ckpt" / "latest").exists()
