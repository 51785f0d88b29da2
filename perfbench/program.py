"""The system under test, as the benchmark drives it: the PyTorch and CUDA
port's CLI configuration, its pipeline built with the run's weights, the
scripted face in front of its detect stage, and one clip served the way
``cli.run --path_video clip`` serves it.

The benchmark reads from the program only what the timed path produces (the
``ClipResult``, the detector's packed outputs, the static CNN's outputs as
``VisualStage.run_static_from_frames`` returns them) and its kernel names.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from perfbench.face import ScriptedFace

#: the program's class of each family's model
FAMILY_OF = {"RetinaFace": "retinaface", "EmotionResNet50": "emotion_resnet50",
             "TemporalLSTM": "temporal_lstm", "ExprModel": "expr_model"}


def pipeline_config(config: dict, weights_dir: str):
    """The ``PipelineConfig`` the CLI builds from the configuration's argv
    (``weights_dir`` holds no release file: the run's weights are handed in),
    with the configuration's ``overrides``."""
    from avcer_tpu_torch.cli import run as cli

    cfg = cli.config_from_args(cli.parse_args(list(config["argv"]) + ["--weights_dir",
                                                                      weights_dir]))
    return dataclasses.replace(cfg, **config.get("overrides", {}))


def build(cfg, weights: dict, device, wav2vec2_config=None):
    """``builder.build_pipeline`` with every family's weights taken from
    ``weights`` ({family: state dict}, loaded strictly where the builder
    would initialise from its own seed)."""
    from avcer_tpu_torch.pipeline import builder

    def load(model, generator):
        model.load_state_dict(weights[FAMILY_OF[type(model).__name__]], strict=True)
        return model

    seeded = builder.seeded_init_
    builder.seeded_init_ = load
    try:
        return builder.build_pipeline(cfg, wav2vec2_config=wav2vec2_config, device=device)
    finally:
        builder.seeded_init_ = seeded


@dataclasses.dataclass
class Served:
    """What one clip's timed path produced."""

    result: object  # the ClipResult
    packed: list  # the detector's packed outputs, batch by batch
    static: list  # (probabilities, features) of each static CNN call


class Program:
    """A built pipeline behind the scripted face."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.face = ScriptedFace(pipe.detect)
        pipe.detect = self.face
        self.static: list = []
        run_static = pipe.visual.run_static_from_frames

        def captured(frames_dev, present_idx, boxes):
            out = run_static(frames_dev, present_idx, boxes)
            self.static.append(out)
            return out

        pipe.visual.run_static_from_frames = captured

    def serve(self, clip, path_save: str) -> Served:
        from avcer_tpu_torch.pipeline.media import ArrayReader

        self.face.start_clip(clip.boxes)
        self.static = []
        result = self.pipe.run(ArrayReader(clip.frames, clip.fps, clip.name), path_save,
                               wav=clip.wav)
        return Served(result, list(self.face.packed), list(self.static))


def serving_of(cfg) -> dict:
    """The serving switches of a ``PipelineConfig``, in the terms of a
    configuration file's ``serving`` block."""
    return dict(backbone=cfg.detector.backbone, long_side=cfg.detector.long_side,
                det_stride=cfg.detector.stride, det_batch=cfg.detector.batch_size,
                cnn_batch=cfg.visual.batch_size, cnn_stride=cfg.visual.cnn_stride,
                shared_extractor=cfg.audio.shared_extractor,
                quant=cfg.detector.quant == "int8", dtype=cfg.detector.dtype,
                audio_batch=cfg.audio.batch_size, wire=cfg.detector.transfer_format,
                fused=cfg.detector.fused_ssh, save_plot=cfg.save_plot)


def free(program: Program) -> None:
    """Drop the pipeline and return its device memory."""
    import gc

    import torch

    program.pipe = program.face = None
    program.static = []
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def static_rows(static: list) -> tuple[np.ndarray, np.ndarray]:
    """The static CNN's rows of a clip, in the order it computed them."""
    if not static:
        return np.zeros((0, 7), np.float32), np.zeros((0, 512), np.float32)
    return np.concatenate([p for p, _ in static]), np.concatenate([f for _, f in static])


def no_weights_dir(tmp: str) -> str:
    return os.path.join(tmp, "no_release_files")
