"""Visual model training CLI (avcer_tpu/cli/train_visual.py) on one GPU:

    python -m avcer_tpu_torch.cli.train_visual --data_root D --model static|dynamic
        [--epochs 10] [--batch_size 64] [--lr 1e-4] [--log_root logs/visual] [--device cuda]

``static`` trains the EmotionResNet50 on a folder of crops
(``<root>/<class_idx>/<img>.jpg``, resized nearest to 224 x 224 by
``CropLoader``), normalised inside the model, bf16 compute under autocast,
BatchNorm on batch statistics with torch's momentum 0.01. ``dynamic`` trains
the TemporalLSTM in f32 on ``<root>/<name>.npz`` files holding ``features``
[T, 512] and ``labels`` [T]: win 10 / step 5 windows with majority labels.
Both with CE (no smoothing) and Adam with the warm-restart cosine; the best
export is ``<log_root>/best_static.pth`` or ``best_dynamic.pth``.

Refused by name: ``--data_parallel`` above 1 (ROADMAP queue 1, parallelism
(item 11)).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Iterator

import numpy as np
import torch

from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
from avcer_tpu_torch.ops.image import vggface_normalize

log = logging.getLogger("avcer_tpu_torch")


def iter_image_folder(root: str) -> list[tuple[str, int]]:
    items = []
    for cls in sorted(os.listdir(root)):
        cdir = os.path.join(root, cls)
        if not os.path.isdir(cdir) or not cls.isdigit():
            continue
        for name in sorted(os.listdir(cdir)):
            if name.lower().endswith((".jpg", ".png", ".jpeg")):
                items.append((os.path.join(cdir, name), int(cls)))
    return items


class CropLoader:
    """Batches of 224x224 BGR uint8 crops + labels, reshuffled each epoch."""

    def __init__(self, items, batch_size: int, seed: int = 0, train: bool = True):
        self.items = items
        self.batch_size = batch_size
        self.seed = seed
        self.train = train
        self.epoch = 0

    def __len__(self):
        return len(self.items) // self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        import cv2

        from avcer_tpu_torch.pipeline.media import resize_nearest_np

        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = np.arange(len(self.items))
        if self.train:
            rng.shuffle(order)
        for b in range(len(self)):
            xs, ys = [], []
            for i in order[b * self.batch_size: (b + 1) * self.batch_size]:
                path, label = self.items[int(i)]
                img = cv2.imread(path)
                xs.append(resize_nearest_np(img, (224, 224)))
                ys.append(label)
            yield np.stack(xs), np.asarray(ys, np.int32)


def window_sequences(features: np.ndarray, win: int = 10, step: int = 5) -> np.ndarray:
    """win/step windows padded by repeating the last element."""
    out = []
    for s in range(0, len(features), step):
        w = features[s: s + win]
        if len(w) < win:
            w = np.concatenate([w, np.repeat(w[-1:], win - len(w), axis=0)])
        out.append(w)
        if s + win >= len(features):
            break
    return np.stack(out) if out else np.zeros((0, win, features.shape[-1]))


class StaticWrapper(EmotionResNet50):
    """EmotionResNet50 on uint8 BGR crops (normalised inside) with the
    trainer's signature: logits, or (logits, features)."""

    def forward(self, x: torch.Tensor, return_features: bool = False):
        logits, feats = super().forward(vggface_normalize(x))
        return (logits, feats) if return_features else logits


class LSTMWrap(TemporalLSTM):
    def forward(self, x: torch.Tensor, return_features: bool = False):
        out = super().forward(x)
        return (out, out) if return_features else out


def parse_args(argv=None) -> argparse.Namespace:
    from avcer_tpu_torch.train.trainer import PARALLELISM

    p = argparse.ArgumentParser(description="avcer-tpu PyTorch/CUDA visual training")
    p.add_argument("--data_root", required=True, help="AffectNet-style crop folders")
    p.add_argument("--model", choices=["static", "dynamic"], default="static")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--log_root", default="logs/visual")
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if a.data_parallel > 1:
        p.error(f"--data_parallel is not ported ({PARALLELISM})")
    return a


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    a = parse_args(argv)

    from avcer_tpu_torch.core.config import OptimConfig, TrainConfig
    from avcer_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(
        model=a.model, num_classes=7, epochs=a.epochs, batch_size=a.batch_size,
        optim=OptimConfig(lr=a.lr), log_root=a.log_root, loss="weighted_ce",
        label_smoothing=0.0,
    )
    if a.model == "static":
        loader = CropLoader(iter_image_folder(a.data_root), a.batch_size)
        trainer = Trainer(StaticWrapper(num_classes=7), cfg,
                          iters_per_epoch=max(1, len(loader)), unfreeze_last_n=0,
                          wav2vec2_layers=0, device=a.device, dtype="bfloat16")
        state = trainer.init_state()
        trainer.fit(state, loader, epochs=cfg.epochs, best_family="best_static",
                    log_fn=log.info)
    else:
        train_dynamic(a, cfg)
    return 0


def train_dynamic(a, cfg):
    """The TemporalLSTM on ``<data_root>/*.npz`` ({features [T, 512], labels
    [T]}): win 10 / step 5 windows, majority labels."""
    from avcer_tpu_torch.train.data.windowing import majority_label
    from avcer_tpu_torch.train.trainer import Trainer

    xs, ys = [], []
    for path in sorted(glob.glob(os.path.join(a.data_root, "*.npz"))):
        data = np.load(path)
        feats, labels = data["features"], data["labels"]
        for s in range(0, len(feats), 5):
            w = feats[s: s + 10]
            lw = labels[s: s + 10]
            if len(w) < 10:
                w = np.concatenate([w, np.repeat(w[-1:], 10 - len(w), axis=0)])
                lw = np.concatenate([lw, np.repeat(lw[-1:], 10 - len(lw))])
            xs.append(w)
            ys.append(majority_label(lw))
            if s + 10 >= len(feats):
                break
    if not xs:
        raise SystemExit(f"no .npz feature files under {a.data_root}")
    x_all = np.stack(xs).astype(np.float32)
    y_all = np.asarray(ys, np.int32)
    bs = min(cfg.batch_size, len(x_all))
    trainer = Trainer(LSTMWrap(7), cfg, iters_per_epoch=max(1, len(x_all) // bs),
                      unfreeze_last_n=0, wav2vec2_layers=0, device=a.device)
    state = trainer.init_state()

    class _Loader:
        """Reshuffled finite iterable (fit() iterates it once per epoch)."""

        def __init__(self):
            self._epoch = 0

        def __iter__(self):
            order = np.random.default_rng(self._epoch).permutation(len(x_all))
            self._epoch += 1
            for s in range(0, len(order) - bs + 1, bs):
                idx = order[s: s + bs]
                yield x_all[idx], y_all[idx]

    trainer.fit(state, _Loader(), epochs=cfg.epochs, best_family="best_dynamic",
                log_fn=log.info)
    return trainer


if __name__ == "__main__":
    raise SystemExit(main())
