"""Audio emotion training CLI (avcer_tpu/cli/train_audio.py):

    python -m avcer_tpu_torch.cli.train_audio --config c.json [--epochs N] [--resume]
        [--device cuda]

The same JSON config (``--print_example_config``): ABAW-EXPR and MELD
concatenated, ExprModel V1 / V2 / V3 at 7 or 8 classes over the full
wav2vec2-large (random init from the seed, as the JAX CLI), the last 4
encoder layers trained for V3 and 2 for V1 / V2, weighted CE with label
smoothing 0.2 at 8 classes or the soft focal loss at 7, Adam at 1e-4 with
the warm-restart cosine per batch, mixup 0.3 and the three wave
augmentations with ``AUGMENTATION``, ``REMAT`` recomputing the trainable
layers, bf16 compute under autocast over f32 parameters. The best-F1 export
goes to ``<LOGS_ROOT>/best_<variant>.pth`` (a reference-layout state dict),
the resumable checkpoint, ``stats.csv``, TensorBoard scalars and
``source.log`` to ``<LOGS_ROOT>/run``.

``DATA_PARALLEL`` and ``MODEL_PARALLEL`` set the trainer's mesh
(``MeshConfig(data, model)``, ``train.trainer``) over the devices of
``--device``'s kind; with fewer devices the mesh error is raised before any
data is read. ``--compile_cache_dir DIR`` (default ``AVCER_COMPILE_CACHE``,
else ``build/avcer_tpu_torch/``) is where the CUDA kernels' libraries are
built and loaded from (``_build``), so that a resumed run loads them warm.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Any

log = logging.getLogger("avcer_tpu_torch")


def example_config() -> dict[str, Any]:
    """The JAX CLI's config template."""
    return {
        "ABAW_WAV_ROOT": "/path/to/abaw/wavs",
        "ABAW_FILTERED_WAV_ROOT": "/path/to/abaw/vocals",
        "ABAW_VIDEO_ROOT": "/path/to/abaw/videos",
        "ABAW_LABELS_ROOT": "/path/to/abaw/EXPR_Classification_Challenge",
        "ABAW_FEATURES_ROOT": "/path/to/abaw/mouth_open_features",
        "MELD_WAV_ROOT": "/path/to/meld/wavs",
        "MELD_LABELS_PATH": "/path/to/meld/train_sent_emo.csv",
        "MELD_VAD_PATH": "/path/to/meld/vad.pickle",
        "LOGS_ROOT": "logs",
        "MODEL_PARAMS": {"model": "v3", "num_classes": 8},
        "AUGMENTATION": False,
        "FILTERED": True,
        "NUM_EPOCHS": 100,
        "BATCH_SIZE": 24,
        "REMAT": True,
        "DATA_PARALLEL": 1,
        "MODEL_PARALLEL": 1,
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="avcer-tpu PyTorch/CUDA audio training")
    p.add_argument("--config", type=str, required=False)
    p.add_argument("--print_example_config", action="store_true")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in the log dir")
    p.add_argument("--compile_cache_dir", type=str, default="",
                   help="the CUDA kernels' library cache (default $AVCER_COMPILE_CACHE, else "
                        "build/avcer_tpu_torch/)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    a = parse_args(argv)
    if a.compile_cache_dir:  # as in the JAX CLI, "" keeps the default
        from avcer_tpu_torch import _build

        _build.set_cache_dir(a.compile_cache_dir)
    if a.print_example_config or not a.config:
        print(json.dumps(example_config(), indent=2))
        return 0
    with open(a.config) as fh:
        c = json.load(fh)

    from avcer_tpu_torch.core.config import MeshConfig, TrainConfig
    from avcer_tpu_torch.parallel.mesh import default_devices
    from avcer_tpu_torch.train.trainer import make_train_mesh

    mesh = MeshConfig(data=int(c.get("DATA_PARALLEL", 1)), model=int(c.get("MODEL_PARALLEL", 1)))
    make_train_mesh(mesh, default_devices(a.device))  # too few devices raise here
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from avcer_tpu_torch.train.augment import default_train_augmentation
    from avcer_tpu_torch.train.data.datasets import (BatchLoader, concat_datasets,
                                                     load_abaw_expr, load_meld)
    from avcer_tpu_torch.train.trainer import Trainer

    mp = c.get("MODEL_PARAMS", {})
    variant = mp.get("model", "v3")
    num_classes = mp.get("num_classes", 8)
    aug = default_train_augmentation() if c.get("AUGMENTATION") else None
    abaw = load_abaw_expr(
        audio_root=c["ABAW_FILTERED_WAV_ROOT"] if c.get("FILTERED") else c["ABAW_WAV_ROOT"],
        labels_root=c["ABAW_LABELS_ROOT"],
        features_root=c["ABAW_FEATURES_ROOT"],
        video_root=c["ABAW_VIDEO_ROOT"],
        num_classes=num_classes,
        transform=aug,
    )
    meld = load_meld(
        audio_root=c["MELD_WAV_ROOT"],
        labels_file=c["MELD_LABELS_PATH"],
        vad_file=c["MELD_VAD_PATH"],
        num_classes=num_classes,
        transform=aug,
    )
    train_ds = concat_datasets([abaw, meld])
    loader = BatchLoader(train_ds, batch_size=c.get("BATCH_SIZE", 24))
    cfg = TrainConfig(
        model=variant,
        num_classes=num_classes,
        epochs=a.epochs or c.get("NUM_EPOCHS", 100),
        batch_size=c.get("BATCH_SIZE", 24),
        augmentation=bool(c.get("AUGMENTATION")),
        filtered=bool(c.get("FILTERED")),
        loss="weighted_ce" if num_classes == 8 else "soft_focal",
        log_root=c.get("LOGS_ROOT", "logs"),
        mesh=mesh,
    )
    model = ExprModel(variant, num_classes, Wav2Vec2Config(remat=bool(c.get("REMAT", True))))
    trainer = Trainer(
        model, cfg,
        class_weights=(train_ds.class_weights(num_classes) if cfg.loss == "weighted_ce"
                       else None),
        iters_per_epoch=max(1, len(loader)),
        unfreeze_last_n=4 if variant == "v3" else 2,
        device=a.device, dtype="bfloat16",
    )
    trainer.write_provenance()
    state = trainer.init_state()
    trainer.fit(state, loader, epochs=cfg.epochs, resume=a.resume,
                best_family=f"best_{variant}", log_fn=log.info)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
