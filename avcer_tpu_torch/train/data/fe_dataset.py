"""Copy of avcer_tpu/train/data/fe_dataset.py (the port imports nothing of the JAX package),
pinned against the original in tests/test_torch_train_data.py.

Feature-extraction (FE) windowing: exhaustive windows with 5 fps label /
mouth-open downsampling.

Behavior contract — the reference's src/audio/data/abaw_fe_dataset.py:
exhaustive (non-filtered) windows over the whole label timeline (:103-150:
no consecutive-sequence split, no mouth filter; the short-window re-anchor
uses max_w_len, not min), plus per-window auxiliary labels downsampled to
5 fps with per-second majority voting (:75, :116-167). afew_fe_dataset.py
adds vad_info to the sample info; windows here carry the same fields.

These windows feed cli/extract_features, whose pickles are what the offline
fusion/weight-search stage consumes (run_extract_features.py:223-271).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from avcer_tpu_torch.train.data.windowing import majority_label
from avcer_tpu_torch.utils.rounding import round_math

NEW_FPS = 5  # label downsample rate (abaw_fe_dataset.py:75)


@dataclass(frozen=True)
class FEWindow:
    filename: str
    start_t: float
    end_t: float
    start_f: int
    end_f: int
    label: int
    mouth_open: np.ndarray  # [max_w_len_sec] per-second majority flags
    downsampled_labels: np.ndarray  # [max_w_len_sec * NEW_FPS] label track


def downsample_indices(frame_rate: float, max_w_len: float) -> list[int]:
    """Frame indices sampled at NEW_FPS within a window
    (abaw_fe_dataset.py:116-124)."""
    r = round_math(frame_rate)
    return [
        round_math(v)
        for v in np.arange(0, r * max_w_len - 1, r / NEW_FPS, dtype=float)
    ]


def per_second_majority(track: np.ndarray) -> np.ndarray:
    """Split a NEW_FPS-rate track into seconds, majority per second
    (abaw_fe_dataset.py:164-167; ties -> smallest value, deterministic)."""
    groups = np.split(track, np.arange(NEW_FPS, len(track), NEW_FPS))
    return np.asarray([majority_label(g) for g in groups])


def make_fe_windows(
    filename: str,
    frame_ids: np.ndarray,  # 1-based, the FULL unfiltered label timeline
    labels: np.ndarray,
    mouth_open: np.ndarray,
    frame_rate: float,
    shift: float = 2.0,
    max_w_len: float = 4.0,
    num_classes: int = 8,
) -> list[FEWindow]:
    r = round_math(frame_rate)
    shift_f = int(shift * r)
    max_f = int(max_w_len * r)
    ds_idx = downsample_indices(frame_rate, max_w_len)
    frames = frame_ids.astype(int).tolist()
    out: list[FEWindow] = []
    for seg in range(0, len(frames), shift_f):
        expr_window = labels[seg : seg + max_f]
        mo_window = mouth_open[seg : seg + max_f]
        start = frames[seg]
        end_idx = seg + len(expr_window)
        end = frames[end_idx - 1] if end_idx > len(frames) - 1 else frames[end_idx]
        if len(expr_window) < max_f:  # re-anchor to tail using max (not min)
            expr_window = labels[-max_f:]
            mo_window = mouth_open[-max_f:]
            start = frames[max(0, len(frames) - max_f)]
            end = frames[-1]
        mo = np.pad(mo_window, (0, max(0, max_f - len(mo_window))), "edge")
        mo_ds = mo[ds_idx]
        mo_sec = per_second_majority(mo_ds)
        lab_pad = np.pad(
            np.asarray(expr_window), (0, max(0, max_f - len(expr_window))), "edge"
        )
        lab_ds = lab_pad[ds_idx]
        lab = majority_label(expr_window)
        if lab > num_classes - 1:
            continue
        out.append(
            FEWindow(
                filename=filename,
                start_t=start / r,
                end_t=end / r,
                start_f=start,
                end_f=end,
                label=int(lab),
                mouth_open=mo_sec,
                downsampled_labels=lab_ds,
            )
        )
    return out
