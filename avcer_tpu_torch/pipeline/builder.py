"""Pipeline construction (avcer_tpu/pipeline/builder.py): the four model
families at full width, weights from a JAX parameter tree handed in or from
a seeded random init, placed on ``device`` in the compute dtype.

The port has no checkpoint loader yet. When the release files are absent it
warns and uses its seeded init, as the JAX package does; when any of them is
present under ``weights_dir`` it raises rather than serve random weights
beside real ones or load them half-way.

With ``quant == "int8"`` in a stage's config its model is built in the int8
variant over the same state dict; the stage then seeds the activation scales
(see each stage). A JAX tree that carries an ``act_scales`` collection hands
its calibrated scales to the model before that, so both sides quantise with
the same scales; the JAX package's calibration sidecars on disk wait for
checkpoint loading (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Mapping, Optional

import torch

from avcer_tpu_torch.core.config import PipelineConfig
from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
from avcer_tpu_torch.models.layers import cast_compute, load_act_scales, seeded_init_
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.pipeline.audio_stage import AudioStage
from avcer_tpu_torch.pipeline.detect import DetectStage
from avcer_tpu_torch.pipeline.runner import Pipeline, check_supported
from avcer_tpu_torch.pipeline.visual import VisualStage

log = logging.getLogger("avcer_tpu_torch")

#: release checkpoint files per family (avcer_tpu/core/checkpoint.py); the
#: detector's file and cache are named after its backbone
RELEASE_FILES = {
    "retinaface": "Resnet50_Final.pth",
    "retinaface_mnet025": "mobilenet0.25_Final.pth",
    "emotion_resnet50": "FER_static_ResNet50_AffectNet.pt",
    "temporal_lstm": "FER_dinamic_LSTM_Aff-Wild2.pt",
    "expr_model": os.path.join("FLW-ExprModelV3-2024.03.02-11.42.11", "epoch_63.pth"),
}
#: the JAX package's converted-weight cache directory per family
JAX_CACHE_NAMES = {"retinaface": "retinaface", "retinaface_mnet025": "retinaface_mnet025",
                   "emotion_resnet50": "emotion_resnet50",
                   "temporal_lstm": "temporal_lstm", "expr_model": "expr_model_8cl"}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _check_no_release_weights(weights_dir: str, backbone: str) -> None:
    other = "retinaface_mnet025" if backbone == "resnet50" else "retinaface"
    found = [p for fam, name in RELEASE_FILES.items() if fam != other
             for p in (os.path.join(weights_dir, name),
                       os.path.join(weights_dir, "jax", JAX_CACHE_NAMES[fam]))
             if os.path.exists(p)]
    if found:
        raise NotImplementedError(
            f"checkpoints found ({', '.join(found)}) but the port cannot load "
            "them yet (ROADMAP queue 1, item 10: build_pipeline loading "
            ".pt/.pth); move them away to run on seeded random weights, or "
            "pass jax_variables")


def build_pipeline(
    cfg: PipelineConfig,
    wav2vec2_config: Optional[Wav2Vec2Config] = None,
    device: torch.device | str = "cuda",
    seed: int = 0,
    jax_variables: Optional[Mapping[str, Mapping[str, Any]]] = None,
) -> Pipeline:
    """Build the detect, visual and audio stages on ``device``.

    ``jax_variables``: optional ``{family: numpy variable tree}`` for the
    families "retinaface" (either backbone's tree, as ``cfg.detector.backbone``
    says), "emotion_resnet50", "temporal_lstm" and "expr_model", converted
    with ``core.convert`` and loaded strictly; every
    family not given is initialised from ``torch.Generator().manual_seed(seed)``.
    """
    check_supported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    w2v2 = wav2vec2_config or Wav2Vec2Config()
    if cfg.audio.quant == "int8":
        w2v2 = dataclasses.replace(w2v2, quant=True)
    models = {
        # the fused switches select the CUDA kernels K3 / K4 inside the models
        "retinaface": RetinaFace(
            backbone=cfg.detector.backbone,
            fused_layer1=cfg.detector.fused_layer1, fused_tails=cfg.detector.fused_tails,
            fused_entries=cfg.detector.fused_entries, fused_ssh=cfg.detector.fused_ssh,
            fused_fpn=cfg.detector.fused_fpn, quant=cfg.detector.quant == "int8"),
        "emotion_resnet50": EmotionResNet50(cfg.visual.num_classes, fused=cfg.visual.fused,
                                            fused_entries=cfg.visual.fused_entries,
                                            quant=cfg.visual.quant == "int8"),
        "temporal_lstm": TemporalLSTM(cfg.visual.num_classes),
        "expr_model": ExprModel(cfg.audio.num_classes, w2v2),
    }
    given = dict(jax_variables or {})
    unknown = set(given) - set(models)
    if unknown:
        raise ValueError(f"jax_variables: unknown families {sorted(unknown)}")
    if len(given) < len(models):
        _check_no_release_weights(cfg.weights_dir, cfg.detector.backbone)
        log.warning("no checkpoints for %s under %s — using seeded random "
                    "initialization (outputs will not match the published models)",
                    sorted(set(models) - set(given)), cfg.weights_dir)
    gen = torch.Generator().manual_seed(seed)
    for family, model in models.items():
        if family in given:
            model.load_state_dict(convert.CONVERTERS[family](given[family]), strict=True)
            scales = convert.act_scales(family, given[family])
            if scales is not None:
                load_act_scales(model, scales)
        else:
            seeded_init_(model, gen)
        model.eval().requires_grad_(False)

    def place(model: torch.nn.Module, dtype_name: str) -> torch.nn.Module:
        return cast_compute(model, _DTYPES[dtype_name]).to(device)

    detect = DetectStage(cfg.detector, place(models["retinaface"], cfg.detector.dtype),
                         device=device)
    visual = VisualStage(place(models["emotion_resnet50"], cfg.visual.dtype),
                         models["temporal_lstm"].to(device),
                         num_classes=cfg.visual.num_classes,
                         batch_size=cfg.visual.batch_size, device=device,
                         quant=cfg.visual.quant)
    audio = AudioStage(place(models["expr_model"], cfg.audio.dtype), cfg.audio, device=device)
    return Pipeline(cfg, detect, visual, audio, device=device)
