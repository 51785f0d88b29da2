"""Checkpoint resolution (avcer_tpu/core/checkpoint.py): the reference's
release files under ``weights_dir``, read with ``torch.load(weights_only=True)``.

For each model family:

- the release file is present: it is loaded (``load_torch_state_dict``); a
  JAX orbax cache ``jax/<family>`` beside it is skipped with a log line;
- only the JAX cache is present: ``NotImplementedError``. The port has no
  orbax reader (ROADMAP queue 1, item 10), and seeded weights served beside
  real ones would go unnoticed;
- neither: ``resolve`` returns None and the caller uses its seeded init.

A JAX calibration sidecar ``jax/<family>_act_scales`` raises as well when the
family is served in int8: the port cannot read it, and would quantise with
other scales than the JAX package does.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

log = logging.getLogger("avcer_tpu_torch")

#: release file per family, relative to ``weights_dir`` (the JAX package's
#: names: the detector's family is named after its backbone, the audio
#: model's after its class count)
TORCH_FILES = {
    "emotion_resnet50": "FER_static_ResNet50_AffectNet.pt",
    "temporal_lstm": "FER_dinamic_LSTM_Aff-Wild2.pt",
    "retinaface": "Resnet50_Final.pth",
    "retinaface_mnet025": "mobilenet0.25_Final.pth",
    "expr_model_8cl": os.path.join("FLW-ExprModelV3-2024.03.02-11.42.11", "epoch_63.pth"),
    "expr_model_7cl": os.path.join("7cl-FLW-ExprModelV2-2024.03.04-11.52.11", "epoch_51.pth"),
    "s3fd": "s3fd_weights.pth",
}

_NOT_READ = "ROADMAP queue 1, item 10: the port reads release files, not the JAX orbax cache"


def detector_family(backbone: str) -> str:
    return "retinaface" if backbone == "resnet50" else "retinaface_mnet025"


def audio_family(num_classes: int) -> str:
    return "expr_model_8cl" if num_classes == 8 else "expr_model_7cl"


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a checkpoint file, unwrapped from the training
    wrapper's ``model_state_dict`` and then ``state_dict``; other entries
    (epoch, optimizer) are left out."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if torch.is_tensor(v)}


def resolve(weights_dir: str, family: str, int8: bool = False,
            torch_file: Optional[str] = None) -> Optional[dict[str, torch.Tensor]]:
    """The release state dict of ``family`` (a key of ``TORCH_FILES``), or
    None when ``weights_dir`` holds neither its file nor a JAX cache of it.
    ``int8``: the family is served quantised. ``torch_file``: another file
    name under ``weights_dir`` (or an absolute path) than the family's."""
    cache = os.path.join(weights_dir, "jax", family)
    if int8 and os.path.isdir(cache + "_act_scales"):
        raise NotImplementedError(
            f"{cache}_act_scales holds the JAX package's int8 calibration of {family}, which "
            f"the port cannot read ({_NOT_READ}); move it away to calibrate on the clip")
    path = os.path.join(weights_dir, torch_file or TORCH_FILES[family])
    if os.path.exists(path):
        if os.path.isdir(cache):
            log.info("%s: loading %s; the JAX cache %s is skipped", family, path, cache)
        return load_torch_state_dict(path)
    if os.path.isdir(cache):
        raise NotImplementedError(
            f"{cache} holds converted weights of {family} but {path} is absent ({_NOT_READ}); "
            "put the release file beside it")
    return None
