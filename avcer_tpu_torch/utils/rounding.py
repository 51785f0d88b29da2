"""Copy of avcer_tpu/utils/rounding.py (the port imports nothing of the JAX package),
pinned against the original in tests/test_torch_train_data.py.

Rounding/grouping utilities shared by datasets and evaluation.

- ``round_math``: round-half-away-from-zero
  (the reference's src/audio/utils/common_utils.py:111-130) — used for all
  fps-derived window arithmetic, so replicated exactly.
- ``majority_voting``: file-wise mode grouping of window predictions
  (common_utils.py:74-108).
"""

from __future__ import annotations

import math

import numpy as np


def round_math(val: float) -> int:
    frac, whole = math.modf(val)
    if frac >= 0.5:
        return int(whole + 1)
    if frac <= -0.5:
        return int(whole - 1)
    return int(math.ceil(whole))


def array_to_bytes(x: np.ndarray) -> bytes:
    """np array -> npy bytes (common_utils.py:133-145)."""
    import io

    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=True)
    return buf.getvalue()


def bytes_to_array(b: bytes) -> np.ndarray:
    """npy bytes -> np array (common_utils.py:148-157)."""
    import io

    return np.load(io.BytesIO(b), allow_pickle=True)


def majority_voting(
    targets: list[int],
    predicts: np.ndarray,  # [N, C] probabilities or logits
    filenames: list[str],
) -> tuple[list, list[np.ndarray], list[str]]:
    """Group window-level predictions by filename, take the mode class,
    return one-hot rows (common_utils.py:74-108 semantics: pandas mode picks
    the smallest mode on ties; groups ordered by filename)."""
    import pandas as pd

    df = pd.DataFrame(
        {
            "targets": targets,
            "predicts": np.argmax(np.asarray(predicts), axis=1),
            "filenames": filenames,
        }
    )
    grouped = df.groupby("filenames", as_index=False).agg(
        lambda x: pd.Series.mode(x)[0]
    )
    c = np.asarray(predicts).shape[1]
    preds = [(np.arange(c) == i).astype(int) for i in grouped["predicts"].values]
    return grouped["targets"].to_list(), preds, grouped["filenames"].to_list()
