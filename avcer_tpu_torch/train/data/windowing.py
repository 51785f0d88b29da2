"""Copy of avcer_tpu/train/data/windowing.py (the port imports nothing of the JAX package),
pinned against the original in tests/test_torch_train_data.py.

Training-corpus windowing — the core of every reference dataset class.

Behavior contract — the reference's src/audio/data/abaw_expr_dataset.py:
``parse_features`` (:79-188):

- all window arithmetic uses ``round_math(frame_rate)`` (half away from zero)
- mouth-open filtering: drop label −1 frames and frames inside closed-mouth
  runs lasting >= threshold seconds (:122-132)
- split remaining rows into consecutive-frame sequences (frame-id gaps > 1
  start a new sequence, :135-138)
- window each sequence with (shift, max_w_len, min_w_len) in frames; windows
  shorter than min_w_len re-anchor to the sequence tail (:140-165); window
  end uses the NEXT frame id unless at the sequence tail (:150-155 — the
  "skip last frame" quirk)
- window label = majority vote (python ``max(set, key=count)`` tie order —
  first-encountered in set iteration; we use the smallest label on ties,
  deterministic) (:166)
- labels above num_classes−1 are dropped (:167-168)
- duplicate windows (identical dicts) are dropped (:181)

MELD (meld_dataset.py) and C-EXPR-DB (c_expr_dataset.py) reuse the same
engine over VAD speech segments / unlabeled timelines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from avcer_tpu_torch.utils.rounding import round_math


@dataclass(frozen=True)
class Window:
    filename: str
    start_t: float
    end_t: float
    start_f: int
    end_f: int
    label: int


def filter_mouth_closed(
    frame_ids: np.ndarray,  # [N] 1-based frame ids
    labels: np.ndarray,  # [N] expr labels, -1 = unlabeled
    mouth_open: np.ndarray,  # [N] 0/1
    frame_rate: float,
    threshold_sec: float = 0.5,
) -> np.ndarray:
    """Boolean keep-mask: label != -1 AND (mouth open OR the closed-mouth run
    containing the frame is shorter than threshold)."""
    mouth_closed = 1 - np.asarray(mouth_open)
    # run ids over equal consecutive values (pandas diff().ne(0).cumsum())
    change = np.ones(len(mouth_closed), bool)
    change[1:] = mouth_closed[1:] != mouth_closed[:-1]
    run_id = np.cumsum(change)
    run_sizes = np.bincount(run_id)[run_id]
    thr = threshold_sec * round_math(frame_rate)
    return (labels != -1) & ((run_sizes < thr) | (mouth_open == 1))


def split_sequences(frame_ids: np.ndarray) -> list[np.ndarray]:
    """Index groups of consecutive frame ids (gap > 1 splits)."""
    if len(frame_ids) == 0:
        return []
    gaps = np.nonzero(np.diff(frame_ids) > 1)[0] + 1
    return np.split(np.arange(len(frame_ids)), gaps)


def majority_label(window_labels: Sequence[int]) -> int:
    """Reference uses ``max(set(x), key=x.count)`` whose tie order is set
    iteration order; we resolve ties to the smallest label, deterministic."""
    vals, counts = np.unique(np.asarray(window_labels), return_counts=True)
    return int(vals[np.argmax(counts)])


def make_windows(
    filename: str,
    frame_ids: np.ndarray,  # 1-based frame ids (post-filter), ascending
    labels: np.ndarray,  # same length; use a constant array for unlabeled
    frame_rate: float,
    shift_sec: float = 2.0,
    min_sec: float = 2.0,
    max_sec: float = 4.0,
    num_classes: int = 8,
) -> list[Window]:
    r = round_math(frame_rate)
    shift = int(shift_sec * r)
    max_w = int(max_sec * r)
    min_w = int(min_sec * r)
    out: list[Window] = []
    seen: set[tuple] = set()
    for seq in split_sequences(frame_ids):
        frames = frame_ids[seq].astype(int).tolist()
        exprs = np.asarray(labels)[seq].tolist()
        if len(frames) < min_w:
            continue
        for seg in range(0, len(frames), shift):
            window_labels = exprs[seg : seg + max_w]
            start = frames[seg]
            end_idx = seg + len(window_labels)
            end = frames[end_idx - 1] if end_idx > len(frames) - 1 else frames[end_idx]
            if len(window_labels) < min_w:
                window_labels = exprs[-max_w:]
                start = frames[max(0, len(frames) - max_w)]
                end = frames[-1]
            lab = majority_label(window_labels)
            if lab > num_classes - 1:
                continue
            w = Window(
                filename=filename,
                start_t=start / r,
                end_t=end / r,
                start_f=start,
                end_f=end,
                label=lab,
            )
            key = (w.filename, w.start_t, w.end_t, w.start_f, w.end_f, w.label)
            if key not in seen:  # reference dedups via a set of dicts
                seen.add(key)
                out.append(w)
    return out


def windows_from_segments(
    filename: str,
    segments: list[tuple[int, int]],  # (start_sample, end_sample) speech spans
    sr: int,
    label: int,
    shift_sec: float = 2.0,
    min_sec: float = 2.0,
    max_sec: float = 4.0,
    num_classes: int = 8,
) -> list[Window]:
    """MELD-style sample-space windowing over VAD speech segments
    (meld_dataset.py:135-170): segments shorter than min skip entirely;
    windows clamp to segment bounds; short tails re-anchor to the segment
    end; duplicates drop; a constant label applies to every window."""
    shift = round(shift_sec * sr)
    max_w = round(max_sec * sr)
    min_w = round(min_sec * sr)
    if label > num_classes - 1:
        return []
    out: list[Window] = []
    seen: set[tuple] = set()
    for s_start, s_end in segments:
        s_len = s_end - s_start
        if s_len < min_w:
            continue
        for seg in range(0, s_len, shift):
            start = s_start + seg
            end = min(s_end, s_start + seg + max_w)
            if end - start < min_w:
                start = max(s_start, s_end - max_w)
                end = s_end
            key = (filename, start / sr, end / sr, start, end, label)
            if key not in seen:
                seen.add(key)
                out.append(
                    Window(
                        filename=filename,
                        start_t=start / sr,
                        end_t=end / sr,
                        start_f=start,
                        end_f=end,
                        label=label,
                    )
                )
    return out


def pad_window_constant(wav: np.ndarray, max_samples: int) -> np.ndarray:
    """Zero-pad a training window to the fixed length
    (abaw_expr_dataset.py:283-288)."""
    if len(wav) >= max_samples:
        return wav[:max_samples]
    return np.concatenate([wav, np.zeros(max_samples - len(wav), wav.dtype)])
