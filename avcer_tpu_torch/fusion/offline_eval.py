"""Offline multi-corpus evaluation + weight optimization + submissions
(avcer_tpu/fusion/offline_eval.py): host numpy, apart from the compound
decision of ``compound_submission``, which runs on ``device``.

Capability parity with the reference's get_pred_{av,video,audio}.py:

- per-video prediction caches are CSVs in the formats the pipeline writes
  (static__*/dynamic__* in video order, audio CSVs in fusion order with a
  ``frames`` column)
- alignment semantics (get_pred_av.py:77-195): label rows with class -1/7
  drop; dynamic/audio logits softmax AFTER audio's frame groupby-mean; when
  a modality runs short of the labels, its last row forward-fills
- fused metrics: UAR/Acc/F1/precision + confusion matrix artifact +
  metrics pickle (get_pred_av.py:19-74); without matplotlib the pickle is
  written and the confusion-matrix pdf skipped with a warning
- weight optimization on the validation corpus: Dirichlet 10k draws + 3-way
  grid (get_pred_av.py:391-406 -> fusion.weight_search, on the card)
- C-EXPR-DB challenge txts per rule combination (get_pred_av.py:198-334 ->
  fusion.compound)
"""

from __future__ import annotations

import logging
import os
import pickle
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

import torch

from avcer_tpu_torch.core import registry
from avcer_tpu_torch.ops import fusion as fusion_ops
from avcer_tpu_torch.train.metrics import confusion, reference_metrics

log = logging.getLogger("avcer_tpu_torch")


def np_softmax(m: np.ndarray) -> np.ndarray:
    e = np.exp(m - m.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@dataclass
class AlignedPredictions:
    trues: np.ndarray  # [N]
    stat: np.ndarray  # [N, 7] fusion order, probabilities
    dyn: np.ndarray  # [N, 7]
    audio: np.ndarray  # [N, 7]


def load_video_csvs(path_stat: str, path_dyn: str) -> tuple[np.ndarray, np.ndarray]:
    """Read static/dynamic CSVs (video-order columns) into fusion order."""
    import pandas as pd

    emo = list(registry.AUDIO_EMOTIONS_7)
    stat = pd.read_csv(path_stat)[emo].values
    dyn = pd.read_csv(path_dyn)[emo].values
    return stat, dyn


def load_audio_csv(path: str) -> np.ndarray:
    """Audio CSV -> per-frame mean logits (fusion order, first 7 cols)."""
    import pandas as pd

    df = pd.read_csv(path)
    df = df.groupby(["frames"]).mean().reset_index()
    return df[list(registry.AUDIO_EMOTIONS_7)].values


def align_video(
    labels: np.ndarray,  # per-frame int labels; -1/7 rows are dropped
    stat: np.ndarray,
    dyn: np.ndarray,
    audio_frame_logits: np.ndarray,
) -> AlignedPredictions:
    """get_pred_av.py:107-135 semantics for one video."""
    keep = ~np.isin(labels, (-1, 7))
    idx = np.nonzero(keep)[0]
    trues = labels[idx]

    def take(arr: np.ndarray, n_target: int) -> np.ndarray:
        rows = arr[idx[idx < len(arr)]]
        if len(rows) == 0 and n_target > 0:
            # a silent 0-row return would surface later as an opaque
            # broadcasting error inside evaluate_fusion
            raise ValueError(
                "prediction CSV has no rows covering the kept label frames"
                f" (first kept frame {idx[0]}, prediction rows {len(arr)})"
            )
        if len(rows) < n_target:
            rows = np.vstack([rows, np.repeat(rows[-1:], n_target - len(rows), 0)])
        return rows

    n = len(trues)
    stat_a = take(stat, n)
    dyn_a = np_softmax(take(dyn, n))
    audio_a = np_softmax(take(audio_frame_logits[:, :7], n))
    return AlignedPredictions(trues=trues, stat=stat_a, dyn=dyn_a, audio=audio_a)


def evaluate_fusion(
    aligned: AlignedPredictions,
    weights_1: np.ndarray,  # [3, 7]
    weights_2: Sequence[float] = (1.0, 1.0, 1.0),
    corpus: str = "corpus",
    modality: str = "av",
    weight_type: str = "sd",
    save_root: Optional[str] = None,
) -> dict:
    """get_metrics equivalent: fused argmax -> UAR/Acc/F1/precision; with
    ``save_root`` the metrics pickle and, where matplotlib is installed, the
    confusion-matrix pdf."""
    preds = [aligned.stat, aligned.dyn, aligned.audio]
    fused = sum(p * w1[None, :] * w2 for p, w1, w2 in zip(preds, weights_1, weights_2))
    pred_cls = fused.argmax(-1).astype(np.int32)
    u, a, f, p, m = reference_metrics(aligned.trues, pred_cls)
    out = {
        "uar_av": u, "acc_av": a, "f1_av": f, "precision_av": p, "mean_av": m,
        "weights_1_av": np.asarray(weights_1), "weights_2_av": list(weights_2),
    }
    if save_root:
        _save_conf_matrix(confusion(aligned.trues, pred_cls, 7), save_root, corpus, modality,
                          weight_type, u)
        md_dir = os.path.join(save_root, "metrics_dicts")
        os.makedirs(md_dir, exist_ok=True)
        with open(
            os.path.join(md_dir, f"{corpus}_metrics_dict_{modality}_{weight_type}.pickle"),
            "wb",
        ) as fh:
            pickle.dump(out, fh)
    return out


def _save_conf_matrix(cm: np.ndarray, save_root: str, corpus: str, modality: str,
                      weight_type: str, u: float) -> None:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        # the metrics pickle is written; only the picture needs it
        log.warning("matplotlib is not installed: the confusion-matrix pdf is not written")
        return
    from avcer_tpu_torch.utils import viz

    cm_dir = os.path.join(save_root, "confusion_matrices")
    os.makedirs(cm_dir, exist_ok=True)
    viz.plot_conf_matrix(
        cm, list(registry.AUDIO_EMOTIONS_7),
        save_path=os.path.join(cm_dir, f"{corpus}_{modality}_sd_{weight_type}.pdf"),
        title=f"Audio-Video fusion. {corpus}. UAR = {u * 100:.2f}%",
    )


# ---------------------------------------------------------------------------
# Readers for the reference's cache trees
# ---------------------------------------------------------------------------

#: AFEW emotion-string -> fusion-order class (get_pred_av.py:146-154)
AFEW_EMOTION_TO_CLASS = {
    "Angry": 1, "Disgust": 2, "Fear": 3, "Happy": 4,
    "Neutral": 0, "Sad": 5, "Surprise": 6,
}


def read_abaw_tree(
    path_ann: str,
    root: str,
    path_preds: Sequence[str],
    ann_files: Optional[Sequence[str]] = None,
) -> AlignedPredictions:
    """The get_pred_av.py:77-137 ABAW layout:

    - annotations: ``<path_ann>/<NAME>.csv`` with per-frame labels in a
      "Neutral" column (-1/7 rows dropped)
    - video preds: ``<root>/<path_preds[0]>/{static,dynamic}__<NAME>.csv``
    - audio preds: ``<root>/<path_preds[1]>/<path_preds[2]>/<NAME>.csv``
      (e.g. path_preds = ["video", "audio_mean_0.5", "FLW-ExprModelV3-..."])
    """
    import pandas as pd

    files = list(ann_files) if ann_files is not None else sorted(
        f for f in os.listdir(path_ann) if f.endswith(".csv")
    )
    parts: list[AlignedPredictions] = []
    for ann in files:
        name = ann[:-4]
        labels = pd.read_csv(os.path.join(path_ann, ann))["Neutral"].values
        stat, dyn = load_video_csvs(
            os.path.join(root, path_preds[0], f"static__{name}.csv"),
            os.path.join(root, path_preds[0], f"dynamic__{name}.csv"),
        )
        audio = load_audio_csv(
            os.path.join(root, path_preds[1], path_preds[2], f"{name}.csv")
        )
        parts.append(align_video(labels, stat, dyn, audio))
    if not parts:
        raise FileNotFoundError(f"no annotation csvs under {path_ann}")
    return AlignedPredictions(
        trues=np.concatenate([p.trues for p in parts]),
        stat=np.concatenate([p.stat for p in parts]),
        dyn=np.concatenate([p.dyn for p in parts]),
        audio=np.concatenate([p.audio for p in parts]),
    )


def read_afew_tree(
    afew_data_csv: str, root: str, path_preds: Sequence[str]
) -> AlignedPredictions:
    """The get_pred_av.py:140-195 AFEW layout: ``AFEW_data.csv`` holds one
    (name_video, emotion-string) row per clip; per-video predictions are
    frame-averaged into ONE sample per video (audio CSVs .dropna() first,
    dyn/audio softmaxed before averaging)."""
    import pandas as pd

    df = pd.read_csv(afew_data_csv)
    emo7 = list(registry.AUDIO_EMOTIONS_7)
    trues, stats, dyns, audios = [], [], [], []
    for name_video, emotion in zip(df.name_video, df.emotion):
        name = os.path.splitext(str(name_video))[0]
        stat = pd.read_csv(
            os.path.join(root, path_preds[0], f"static__{name}.csv")
        )[emo7].values
        dyn = np_softmax(
            pd.read_csv(
                os.path.join(root, path_preds[0], f"dynamic__{name}.csv")
            )[emo7].values
        )
        audio_df = pd.read_csv(
            os.path.join(root, path_preds[1], path_preds[2], f"{name}.csv")
        ).dropna()
        audio_df = audio_df.groupby(["frames"]).mean().reset_index()
        audio = np_softmax(audio_df[emo7].values)
        trues.append(AFEW_EMOTION_TO_CLASS[str(emotion)])
        stats.append(stat.mean(0))
        dyns.append(dyn.mean(0))
        audios.append(audio.mean(0))
    if not trues:
        raise FileNotFoundError(f"no rows in {afew_data_csv}")
    return AlignedPredictions(
        trues=np.asarray(trues), stat=np.stack(stats), dyn=np.stack(dyns),
        audio=np.stack(audios),
    )


def iter_audio_sweep(path_pred_root: str):
    """The get_pred_audio.py:265-312 sweep: yields
    (folder, model_name, pred_dir) for every ``audio_{padding}_{step}``
    folder and checkpoint-name subfolder under it."""
    for folder in sorted(os.listdir(path_pred_root)):
        if not folder.startswith("audio_"):
            continue
        fdir = os.path.join(path_pred_root, folder)
        if not os.path.isdir(fdir):
            continue
        for model_name in sorted(os.listdir(fdir)):
            mdir = os.path.join(fdir, model_name)
            if os.path.isdir(mdir):
                yield folder, model_name, mdir


def read_abaw_audio_only(
    path_ann: str, pred_dir: str, ann_files: Optional[Sequence[str]] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Audio-only ABAW alignment (get_pred_audio.py get_abaw_pred): returns
    (trues [N], audio probs [N, 7]) with the -1/7 drop + tail forward-fill."""
    import pandas as pd

    files = list(ann_files) if ann_files is not None else sorted(
        f for f in os.listdir(path_ann) if f.endswith(".csv")
    )
    trues, audios = [], []
    for ann in files:
        name = ann[:-4]
        labels = pd.read_csv(os.path.join(path_ann, ann))["Neutral"].values
        audio = load_audio_csv(os.path.join(pred_dir, f"{name}.csv"))
        keep = ~np.isin(labels, (-1, 7))
        idx = np.nonzero(keep)[0]
        rows = audio[idx[idx < len(audio)]]
        n = int(keep.sum())
        if 0 < len(rows) < n:
            rows = np.vstack([rows, np.repeat(rows[-1:], n - len(rows), 0)])
        trues.append(labels[idx])
        audios.append(np_softmax(rows[:, :7]))
    return np.concatenate(trues), np.concatenate(audios)


def compound_submission(
    stat: np.ndarray,
    dyn: np.ndarray,
    audio: np.ndarray,
    name_video: str,
    weights_1: np.ndarray,
    weights_2: Sequence[float],
    ce_weights_type: bool,
    ce_mask: bool,
    out_dir: str,
    device: torch.device | str = "cuda",
) -> str:
    """Per-rule challenge txt for one video (get_pred_av.py:198-334 pattern);
    the decision runs on ``device``."""
    from avcer_tpu_torch.fusion.compound import save_compound_txt

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    out = fusion_ops.fused_compound_decision(
        dev(stat), dev(dyn), dev(audio), dev(weights_1), dev(list(weights_2)),
        ce_weights_type=ce_weights_type, ce_mask=ce_mask,
    )
    locations = [f"{name_video}/{str(f + 1).zfill(5)}.jpg" for f in range(len(stat))]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"C_EXPR_DB_av_{ce_weights_type}_{ce_mask}_{name_video}.txt"
    )
    save_compound_txt(path, locations, out["av"].cpu().numpy())
    return path
