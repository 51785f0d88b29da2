"""Copy of avcer_tpu/train/data/datasets.py (the port imports nothing of the JAX package),
pinned against the original in tests/test_torch_train_data.py.

Training datasets: ABAW-EXPR, MELD, C-EXPR-DB window datasets + loader.

Capability parity with the reference's src/audio/data/ (abaw_expr_dataset.py,
meld_dataset.py, c_expr_dataset.py): label parsing, mouth-open filtering,
windowing (see windowing.py for the exact contracts), per-window wav slicing
with constant padding, HF-style normalization, and label-count statistics
for class weighting (train_c_audio.py:236-243 uses them).

TPU design: datasets precompute window metadata at construction (as the
reference does) but emit fixed-shape numpy batches through ``BatchLoader`` —
a background-thread prefetching iterator (replaces torch DataLoader worker
processes, train_c_audio.py:225-230) that keeps the single-host CPU ahead of
the device.
"""

from __future__ import annotations

import os
import pickle
import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from avcer_tpu_torch.pipeline.media import read_wav
from avcer_tpu_torch.train.data.windowing import (
    Window,
    filter_mouth_closed,
    make_windows,
    pad_window_constant,
    windows_from_segments,
)

MELD_TO_ABAW = {
    "neutral": 0, "anger": 1, "disgust": 2, "fear": 3,
    "joy": 4, "sadness": 5, "surprise": 6,
}


def _normalize(wav: np.ndarray) -> np.ndarray:
    """HF Wav2Vec2 zero-mean/unit-var normalization (applied per window at
    abaw_expr_dataset.py:291-293)."""
    return (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)


@dataclass
class WindowDataset:
    """A materialized list of windows + how to read their audio."""

    windows: list[Window]
    audio_root: str
    sr: int = 16_000
    max_sec: float = 4.0
    transform: Optional[Callable[[np.ndarray, np.random.Generator], np.ndarray]] = None
    normalize: bool = True
    wav_name_fn: Callable[[str], str] = staticmethod(
        lambda fn: fn.replace("_right", "").replace("_left", "").rsplit(".", 1)[0] + ".wav"
    )
    #: windows store sample offsets (MELD) instead of seconds?
    offsets_in_samples: bool = False

    def __post_init__(self) -> None:
        self._wav_cache: dict[str, np.ndarray] = {}
        counts = np.bincount(
            [w.label for w in self.windows] or [0],
            minlength=max((w.label for w in self.windows), default=0) + 1,
        )
        self.label_counts = counts

    def class_weights(self, num_classes: int) -> np.ndarray:
        """Inverse-frequency weights as used for the weighted CE
        (train_c_audio.py:236-243 divides by class counts)."""
        counts = np.zeros(num_classes)
        counts[: len(self.label_counts)] = self.label_counts
        weights = counts.sum() / np.maximum(counts, 1) / num_classes
        return weights.astype(np.float32)

    def _load_wav(self, name: str) -> np.ndarray:
        if name not in self._wav_cache:
            data, sr = read_wav(os.path.join(self.audio_root, name))
            assert sr == self.sr, f"{name}: {sr} != {self.sr}"
            self._wav_cache[name] = data.mean(0) if data.shape[0] > 1 else data[0]
        return self._wav_cache[name]

    def __len__(self) -> int:
        return len(self.windows)

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> tuple[np.ndarray, int]:
        w = self.windows[index]
        wav = self._load_wav(self.wav_name_fn(w.filename))
        if self.offsets_in_samples:
            s, e = w.start_f, w.end_f
        else:
            s, e = round(self.sr * w.start_t), round(self.sr * w.end_t)
        chunk = wav[s:e].astype(np.float32)
        chunk = pad_window_constant(chunk, int(self.max_sec * self.sr))
        if self.transform is not None and rng is not None:
            chunk = self.transform(chunk, rng)
        if self.normalize:
            chunk = _normalize(chunk)
        return chunk.astype(np.float32), w.label


# ---------------------------------------------------------------------------
# Corpus constructors
# ---------------------------------------------------------------------------


def load_abaw_expr(
    audio_root: str,
    labels_root: str,
    features_root: str,
    shift: float = 2.0,
    min_w_len: float = 2.0,
    max_w_len: float = 4.0,
    num_classes: int = 8,
    video_info: Optional[Callable[[str], tuple[float, float]]] = None,
    video_root: Optional[str] = None,
    mouth_open_threshold: float = 0.5,
    transform=None,
) -> WindowDataset:
    """ABAW EXPR windows (abaw_expr_dataset.py:216-260): per-video label txt
    merged with mouth-open CSVs, filtered, windowed. ``video_info`` maps a
    label filename to (fps, num_frames); defaults to probing video_root."""
    import cv2
    import pandas as pd

    def default_info(lab_filename: str) -> tuple[float, float]:
        base = lab_filename.split(".")[0]
        cands = {base.split(p)[0] for p in ("_right", "_left")}
        for v in os.listdir(video_root):
            if v.split(".")[0] in cands:
                cap = cv2.VideoCapture(os.path.join(video_root, v))
                return cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
        raise FileNotFoundError(lab_filename)

    info = video_info or default_info
    windows: list[Window] = []
    for dp, _, fps_ in os.walk(labels_root):
        for fp in sorted(fps_):
            if ".DS_Store" in fp:
                continue
            path = os.path.join(dp, fp)
            labs = pd.read_csv(path, sep=".", names=["expr"], header=0)
            labs["lab_id"] = labs.index + 1
            feats = pd.read_csv(
                os.path.join(features_root, fp.replace("txt", "csv")),
                sep=",",
                names=["feat_id", "frame", "surface_area_mouth", "mouth_open"],
                header=0,
            )
            merged = labs.merge(feats, how="left", left_on="lab_id", right_on="frame")
            merged[["mouth_open"]] = merged[["mouth_open"]].fillna(0.0)
            frame_rate, _ = info(fp)
            keep = filter_mouth_closed(
                merged["lab_id"].values,
                merged["expr"].values,
                merged["mouth_open"].values,
                frame_rate,
                mouth_open_threshold,
            )
            kept = merged[keep]
            windows.extend(
                make_windows(
                    fp,
                    kept["lab_id"].values,
                    kept["expr"].values,
                    frame_rate,
                    shift,
                    min_w_len,
                    max_w_len,
                    num_classes,
                )
            )
    return WindowDataset(windows=windows, audio_root=audio_root,
                         max_sec=max_w_len, transform=transform)


def load_meld(
    audio_root: str,
    labels_file: str,
    vad_file: str,
    shift: float = 2.0,
    min_w_len: float = 2.0,
    max_w_len: float = 4.0,
    num_classes: int = 8,
    sr: int = 16_000,
    transform=None,
) -> WindowDataset:
    """MELD windows over silero-VAD speech segments (meld_dataset.py:93-178),
    including the broken-file skip and the MELD->ABAW label map."""
    import pandas as pd

    labs = pd.read_csv(labels_file, sep=",").to_dict("records")
    with open(vad_file, "rb") as fh:
        vad_info = pickle.load(fh)
    windows: list[Window] = []
    for lab in labs:
        fn = "dia{0}_utt{1}.wav".format(lab["Dialogue_ID"], lab["Utterance_ID"])
        if "dia125_utt3" in fn or fn not in vad_info:
            continue
        segments = [(s["start"], s["end"]) for s in vad_info[fn]]
        windows.extend(
            windows_from_segments(
                fn, segments, sr, MELD_TO_ABAW[lab["Emotion"]],
                shift, min_w_len, max_w_len, num_classes,
            )
        )
    ds = WindowDataset(
        windows=windows, audio_root=audio_root, sr=sr, max_sec=max_w_len,
        transform=transform,
    )
    ds.wav_name_fn = lambda fn: fn  # MELD filenames are already wavs
    ds.offsets_in_samples = True
    return ds


def load_c_expr(
    audio_root: str,
    wav_names: Sequence[str],
    video_info: Callable[[str], tuple[float, float]],
    shift: float = 2.0,
    min_w_len: float = 2.0,
    max_w_len: float = 4.0,
    num_classes: int = 8,
    dummy_label: int = -2,
) -> WindowDataset:
    """C-EXPR-DB inference windows (c_expr_dataset.py): unlabeled timeline ->
    exhaustive windows with dummy label (labels_root=None mode)."""
    windows: list[Window] = []
    for name in wav_names:
        frame_rate, num_frames = video_info(name)
        ids = np.arange(1, int(num_frames) + 1)
        labs = np.full(len(ids), dummy_label)
        windows.extend(
            make_windows(
                name, ids, labs, frame_rate, shift, min_w_len, max_w_len,
                num_classes=max(num_classes, abs(dummy_label) + 1),
            )
        )
    ds = WindowDataset(windows=windows, audio_root=audio_root, max_sec=max_w_len)
    return ds


def concat_datasets(datasets: Sequence[WindowDataset]) -> "ConcatDataset":
    return ConcatDataset(list(datasets))


class ConcatDataset:
    """torch ConcatDataset equivalent (train_c_audio.py:135-172)."""

    def __init__(self, datasets: list[WindowDataset]):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])
        counts = {}
        for d in datasets:
            for lab, cnt in enumerate(d.label_counts):
                counts[lab] = counts.get(lab, 0) + int(cnt)
        n = max(counts) + 1 if counts else 0
        self.label_counts = np.array([counts.get(i, 0) for i in range(n)])

    def class_weights(self, num_classes: int) -> np.ndarray:
        counts = np.zeros(num_classes)
        counts[: len(self.label_counts)] = self.label_counts
        return (counts.sum() / np.maximum(counts, 1) / num_classes).astype(np.float32)

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def get(self, index: int, rng=None) -> tuple[np.ndarray, int]:
        d = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.datasets[d].get(index - self._offsets[d], rng)


class BatchLoader:
    """Shuffling, fixed-shape, background-prefetching batch iterator."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        nb = len(self)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)

        def producer():
            for b in range(nb):
                idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                xs, ys = zip(*(self.dataset.get(int(i), rng) for i in idx))
                q.put((np.stack(xs), np.asarray(ys, np.int32)))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item
