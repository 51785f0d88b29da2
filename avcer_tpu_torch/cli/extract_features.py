"""Feature extraction CLI (avcer_tpu/cli/extract_features.py) on one GPU:

    python -m avcer_tpu_torch.cli.extract_features --config c.json --checkpoint best_v3.pth
        --out feats.pkl [--variant v3] [--num_classes 8] [--device cuda]

A trained ExprModel (a reference-layout state dict: a release file or
``cli.train_audio``'s best export) runs in bf16 over the ABAW windows of the
training config (``ABAW_WAV_ROOT``), batches of 16 in order; the logits and
the pooled features are regrouped by source file (``regroup_by_filename``)
and pickled. The encoder's attention runs the K2 kernel on the card (no
gradient here). Refused by name: an orbax directory as ``--checkpoint`` (the
port reads release files, ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from collections import defaultdict

import numpy as np

ORBAX = "ROADMAP queue 1, item 10: the port reads release files, not the JAX orbax cache"


def regroup_by_filename(
    windows, logits: np.ndarray, features: np.ndarray, targets: np.ndarray
) -> dict:
    """Per-filename dict of {targets, predicts, features, frame/timestep
    bounds}."""
    out: dict = defaultdict(lambda: {
        "targets": [], "predicts": [], "features": [],
        "start_f": [], "end_f": [], "start_t": [], "end_t": [],
    })
    for i, w in enumerate(windows):
        d = out[w.filename]
        d["targets"].append(int(targets[i]))
        d["predicts"].append(logits[i])
        d["features"].append(features[i])
        d["start_f"].append(w.start_f)
        d["end_f"].append(w.end_f)
        d["start_t"].append(w.start_t)
        d["end_t"].append(w.end_t)
    return {
        k: {kk: (np.stack(vv) if kk in ("predicts", "features") else np.asarray(vv))
            for kk, vv in d.items()}
        for k, d in out.items()
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="avcer-tpu PyTorch/CUDA feature extraction")
    p.add_argument("--config", required=True, help="training-config JSON (see train_audio)")
    p.add_argument("--checkpoint", required=True, help="torch .pth (reference layout)")
    p.add_argument("--out", required=True, help="output pickle path")
    p.add_argument("--variant", default="v3")
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if os.path.isdir(a.checkpoint):
        p.error(f"--checkpoint {a.checkpoint} is a directory (a JAX orbax checkpoint): "
                f"not ported ({ORBAX})")
    return a


def main(argv=None) -> int:
    a = parse_args(argv)

    from avcer_tpu_torch.core import checkpoint, convert
    from avcer_tpu_torch.core.config import TrainConfig
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from avcer_tpu_torch.train.data.datasets import BatchLoader, load_abaw_expr
    from avcer_tpu_torch.train.trainer import Trainer

    with open(a.config) as fh:
        c = json.load(fh)
    model = ExprModel(a.variant, a.num_classes, Wav2Vec2Config())
    ds = load_abaw_expr(
        audio_root=c["ABAW_WAV_ROOT"],
        labels_root=c["ABAW_LABELS_ROOT"],
        features_root=c["ABAW_FEATURES_ROOT"],
        video_root=c["ABAW_VIDEO_ROOT"],
        num_classes=a.num_classes,
    )
    loader = BatchLoader(ds, batch_size=16, shuffle=False, drop_last=False)
    trainer = Trainer(model, TrainConfig(num_classes=a.num_classes), device=a.device,
                      dtype="bfloat16")
    state = trainer.init_state(params=convert.release_state_dict(
        "expr_model", checkpoint.load_torch_state_dict(a.checkpoint)))
    logits, feats = trainer.extract_features(state, loader)
    targets = np.asarray([w.label for w in ds.windows])[: len(logits)]
    grouped = regroup_by_filename(ds.windows[: len(logits)], logits, feats, targets)
    with open(a.out, "wb") as fh:
        pickle.dump(grouped, fh)
    print(f"wrote {a.out} ({len(grouped)} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
