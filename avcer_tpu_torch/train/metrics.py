"""Evaluation metrics with sklearn-parity definitions: a numpy copy of
avcer_tpu/train/metrics.py, pinned against it by the tests.

- UAR = macro recall, Acc = micro recall, macro F1 / precision
  (the reference's data/utils.py:130-135, audio/utils/accuracy_utils.py:51-121)
- competition fusion metric: macro precision/F1/recall over classes 1..6 only
  (data/utils.py:115-122)
- CCC + valence/arousal mean (accuracy_utils.py:124-223)

Pure numpy, with sklearn's zero-division=0 behaviour.
"""

from __future__ import annotations

import numpy as np


def confusion(true: np.ndarray, pred: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (true, pred), 1)
    return cm


def _prf(cm: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(1).astype(np.float64)
    pred_count = cm.sum(0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        recall = np.where(support > 0, tp / support, 0.0)
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1


def uar(true, pred, num_classes: int | None = None) -> float:
    true, pred = np.asarray(true), np.asarray(pred)
    n = num_classes or int(max(true.max(), pred.max())) + 1
    labels = np.unique(true)  # sklearn macro recall averages over present labels
    cm = confusion(true, pred, n)
    _, recall, _ = _prf(cm)
    return float(recall[labels].mean())

def accuracy(true, pred) -> float:
    true, pred = np.asarray(true), np.asarray(pred)
    return float((true == pred).mean())


def macro_f1(true, pred, num_classes: int | None = None) -> float:
    true, pred = np.asarray(true), np.asarray(pred)
    n = num_classes or int(max(true.max(), pred.max())) + 1
    labels = np.unique(np.concatenate([true, pred]))
    cm = confusion(true, pred, n)
    _, _, f1 = _prf(cm)
    return float(f1[labels].mean())


def macro_precision(true, pred, num_classes: int | None = None) -> float:
    true, pred = np.asarray(true), np.asarray(pred)
    n = num_classes or int(max(true.max(), pred.max())) + 1
    labels = np.unique(np.concatenate([true, pred]))
    cm = confusion(true, pred, n)
    precision, _, _ = _prf(cm)
    return float(precision[labels].mean())


def reference_metrics(true, pred) -> tuple[float, float, float, float, float]:
    """(uar, acc, f1, precision, mean) — data/utils.py:130-135."""
    u = uar(true, pred)
    a = accuracy(true, pred)
    f = macro_f1(true, pred)
    p = macro_precision(true, pred)
    return u, a, f, p, float(np.mean((u, a, f, p)))


def fusion_metric(true, pred, classes=range(1, 7)) -> tuple[float, float, float]:
    """(precision, f1, uar) averaged over classes 1..6 only
    (data/utils.py:115-122 via classification_report)."""
    true, pred = np.asarray(true), np.asarray(pred)
    n = int(max(true.max(), pred.max())) + 1
    n = max(n, max(classes) + 1)
    cm = confusion(true, pred, n)
    precision, recall, f1 = _prf(cm)
    cls = list(classes)
    return (
        float(precision[cls].mean()),
        float(f1[cls].mean()),
        float(recall[cls].mean()),
    )


def ccc(true: np.ndarray, pred: np.ndarray) -> float:
    """Concordance correlation coefficient (accuracy_utils.py:124-223)."""
    true = np.asarray(true, np.float64)
    pred = np.asarray(pred, np.float64)
    tm, pm = true.mean(), pred.mean()
    tv, pv = true.var(), pred.var()
    cov = ((true - tm) * (pred - pm)).mean()
    return float(2 * cov / (tv + pv + (tm - pm) ** 2))


def va_score(true_va: np.ndarray, pred_va: np.ndarray) -> tuple[float, float, float]:
    """(ccc_v, ccc_a, mean) for [N, 2] valence/arousal arrays."""
    cv = ccc(true_va[:, 0], pred_va[:, 0])
    ca = ccc(true_va[:, 1], pred_va[:, 1])
    return cv, ca, (cv + ca) / 2
