"""Offline multi-corpus evaluation CLI (avcer_tpu/cli/eval_offline.py), the
reference's get_pred_{av,video,audio}.py equivalent:

    python -m avcer_tpu_torch.cli.eval_offline --ann_root A --preds_root P \
        [--optimize_weights] [--device cuda]

Reads per-video prediction caches (the CSVs the pipeline writes), aligns
them with per-frame annotation files, optionally optimizes fusion weights on
the validation corpus (Dirichlet 10k + 3-way grid, get_pred_av.py:391-406),
computes UAR/Acc/F1/precision with confusion-matrix artifacts, and writes
C-EXPR-DB challenge txts per rule combination. The weight search runs on
``--device`` (default cuda; raises where CUDA is unavailable, never falls
back to the CPU on its own); everything else is host numpy.

Layout expectations (mirroring the reference's cache trees):
  <preds_root>/video/{static__NAME.csv, dynamic__NAME.csv}
  <preds_root>/audio/NAME.csv
  <ann_root>/NAME.csv  with a per-frame label column (default "Neutral",
  matching the reference's annotation frames, get_pred_av.py:107)
The flat layout is also what ``avcer_tpu_torch.cli.run`` writes into its
``--path_save`` (the audio CSV of a 7-class run under audio_<pad>_<step>/).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from avcer_tpu_torch.core import registry
from avcer_tpu_torch.fusion import offline_eval, weight_search


def gather_corpus(ann_root: str, preds_root: str, label_col: str = "Neutral"):
    import pandas as pd

    trues, stats, dyns, audios = [], [], [], []
    for ann in sorted(os.listdir(ann_root)):
        if not ann.endswith(".csv"):
            continue
        name = ann[:-4]
        # this pipeline's own output layout: everything in preds_root with
        # the audio__ prefix (runner.save_outputs); fall back to the
        # video//audio subdir arrangement for hand-built caches
        stat_p = os.path.join(preds_root, f"static__{name}.csv")
        dyn_p = os.path.join(preds_root, f"dynamic__{name}.csv")
        audio_p = os.path.join(preds_root, f"audio__{name}.csv")
        if os.path.exists(stat_p) and not os.path.exists(audio_p):
            # 7-class runs write audio under an audio_{padding}_{step}/
            # subdir (runner.save_outputs, get_prob_audio_7_cl.py:153) while
            # the video CSVs stay flat — probe those before giving up
            cands = sorted(
                glob.glob(
                    os.path.join(preds_root, "audio_*", f"audio__{name}.csv")
                )
            )
            if cands:
                audio_p = cands[0]
        if not os.path.exists(stat_p):
            stat_p = os.path.join(preds_root, "video", f"static__{name}.csv")
            dyn_p = os.path.join(preds_root, "video", f"dynamic__{name}.csv")
            audio_p = os.path.join(preds_root, "audio", f"{name}.csv")
        if not (os.path.exists(stat_p) and os.path.exists(dyn_p) and os.path.exists(audio_p)):
            continue
        labels = pd.read_csv(os.path.join(ann_root, ann))[label_col].values
        stat, dyn = offline_eval.load_video_csvs(stat_p, dyn_p)
        audio = offline_eval.load_audio_csv(audio_p)
        try:
            a = offline_eval.align_video(labels, stat, dyn, audio)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from e
        trues.append(a.trues)
        stats.append(a.stat)
        dyns.append(a.dyn)
        audios.append(a.audio)
    if not trues:
        raise FileNotFoundError("no aligned videos found")
    return (
        np.concatenate(trues),
        np.concatenate(stats),
        np.concatenate(dyns),
        np.concatenate(audios),
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="avcer-tpu PyTorch/CUDA offline evaluation")
    p.add_argument("--ann_root", required=True)
    p.add_argument("--preds_root", required=True)
    p.add_argument(
        "--layout", choices=("flat", "reference"), default="flat",
        help="'reference' reads the reference's actual cache trees: "
             "<preds_root>/<video_subdir>/{static,dynamic}__NAME.csv + "
             "<preds_root>/<audio_folder>/<model_name>/NAME.csv "
             "(get_pred_av.py:77-137); --afew_data switches to the AFEW "
             "per-video layout (get_pred_av.py:140-195)",
    )
    p.add_argument("--video_subdir", default="video")
    p.add_argument("--audio_folder", default="audio_mean_0.5")
    p.add_argument("--model_name", default="FLW-ExprModelV3-2024.03.02-11.42.11")
    p.add_argument("--afew_data", default=None,
                   help="AFEW_data.csv path (name_video, emotion columns)")
    p.add_argument(
        "--audio_sweep_root", default=None,
        help="evaluate every audio_{padding}_{step}/<model> tree under this "
             "root, audio-only (get_pred_audio.py:265-312)",
    )
    p.add_argument("--save_root", default="report/offline_eval")
    p.add_argument("--corpus", default="ABAW")
    p.add_argument("--optimize_weights", action="store_true")
    p.add_argument("--num_dirichlet", type=int, default=10_000)
    p.add_argument(
        "--sweep_audio_dirs", nargs="*", default=None,
        help="audio cache subdirs (e.g. audio_mean_0.5 audio_repeat_0.5) to "
             "sweep like get_pred_audio.py:265-312; default: the single "
             "'audio' dir",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of the weight search; 'cuda' raises if CUDA is "
                        "unavailable")
    a = p.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")

    if a.audio_sweep_root:
        from avcer_tpu_torch.train.metrics import reference_metrics

        results = {}
        for folder, model_name, pred_dir in offline_eval.iter_audio_sweep(
            a.audio_sweep_root
        ):
            trues, audio = offline_eval.read_abaw_audio_only(a.ann_root, pred_dir)
            u, acc, f1, prec, mean = reference_metrics(trues, audio.argmax(-1))
            results[f"{folder}/{model_name}"] = {
                "uar_a": u, "acc_a": acc, "f1_a": f1, "precision_a": prec,
                "mean_a": mean,
            }
        print(json.dumps(results))
        return 0

    if a.layout == "reference":
        if a.afew_data:
            aligned = offline_eval.read_afew_tree(
                a.afew_data, a.preds_root,
                [a.video_subdir, a.audio_folder, a.model_name],
            )
        else:
            aligned = offline_eval.read_abaw_tree(
                a.ann_root, a.preds_root,
                [a.video_subdir, a.audio_folder, a.model_name],
            )
        res = offline_eval.evaluate_fusion(
            aligned, np.asarray(registry.AV_WEIGHTS_8CL), (1, 1, 1),
            corpus=a.corpus, save_root=a.save_root,
        )
        printable = {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in res.items()
        }
        print(json.dumps(printable))
        return 0

    if a.sweep_audio_dirs:
        import shutil
        import tempfile

        results = {}
        for sub in a.sweep_audio_dirs:
            # materialize a preds_root view whose 'audio' dir is the sweep dir
            view = tempfile.mkdtemp(prefix="avcer_sweep_")
            os.symlink(os.path.join(a.preds_root, "video"), os.path.join(view, "video"))
            os.symlink(os.path.join(a.preds_root, sub), os.path.join(view, "audio"))
            try:
                trues, stat, dyn, audio = gather_corpus(a.ann_root, view)
                aligned = offline_eval.AlignedPredictions(trues, stat, dyn, audio)
                res = offline_eval.evaluate_fusion(
                    aligned, registry.AV_WEIGHTS_8CL, (1, 1, 1), corpus=a.corpus,
                )
                results[sub] = {k: v for k, v in res.items()
                                if isinstance(v, float)}
            finally:
                shutil.rmtree(view, ignore_errors=True)
        print(json.dumps(results))
        return 0

    trues, stat, dyn, audio = gather_corpus(a.ann_root, a.preds_root)
    aligned = offline_eval.AlignedPredictions(trues, stat, dyn, audio)

    if a.optimize_weights:
        w1, best = weight_search.search_dirichlet(
            trues, [stat, dyn, audio], num_weights=a.num_dirichlet, seed=42, device=a.device
        )
        w2, best_grid = weight_search.search_grid(trues, [stat, dyn, audio], device=a.device)
        print(json.dumps({"dirichlet_uar": best, "grid_uar": best_grid,
                          "grid_weights": w2}))
    else:
        w1 = registry.AV_WEIGHTS_8CL
        w2 = [1.0, 1.0, 1.0]

    res = offline_eval.evaluate_fusion(
        aligned, np.asarray(w1), tuple(w2) if len(w2) == 3 else (1, 1, 1),
        corpus=a.corpus, save_root=a.save_root,
    )
    printable = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in res.items()}
    print(json.dumps(printable))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
