"""A cell small enough for the CPU: the configuration's own argv at a small
bucket, small batches, a one-layer narrow wav2vec2 (the configuration's
audio family at a shrunk shape), 96 x 64 frames."""

from __future__ import annotations

import dataclasses
import json
import os

from perfbench import harness
from perfbench.reference import models as M

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the audio family's shape shrunk (each key one the program's Wav2Vec2Config takes)
SMALL_AUDIO = dict(hidden_size=256, num_layers=1, num_heads=4, intermediate_size=512,
                   conv_dim=[64] * 7, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)
MIX = dict(clip_seconds=[2, 3], width=96, height=64, fps=25, faces=1, face_px=40,
           face_speed_px=[9, 4], audio=dict(sample_rate=16000, noise_std=0.1),
           loop=dict(kind="closed", clients=1), trace_clips=1, check_clips=2)


def wav2vec2_config():
    from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    return Wav2Vec2Config(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in SMALL_AUDIO.items()})


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        c = json.load(f)
    c["argv"] = c["argv"] + ["--long_side", "96"]
    if "argv" in c["control"]:
        c["control"] = dict(c["control"], argv=c["control"]["argv"] + ["--long_side", "96"])
    return c


def families(config: dict, root: str = ROOT) -> dict:
    """{role: models.Family} of ``config``'s models block, the audio family
    at ``SMALL_AUDIO``."""
    block = dict(config["models"])
    block["audio"] = dict(block["audio"], shape=dict(block["audio"]["shape"], **SMALL_AUDIO))
    return M.load_families(block, root)


def limits(workload: str) -> dict:
    with open(os.path.join(ROOT, "perfbench", "limits", workload + ".json")) as f:
        return json.load(f)["limits"]


def cell(name: str, workload: str) -> harness.Cell:
    c = config(name)
    return harness.Cell(name=workload, chips=1, config=c, mix=dict(MIX),
                        limits=limits(workload), end_to_end=[], per_layer=[],
                        families=families(c))


def small(float32: bool):
    """Small batches; with ``float32`` every stage computes in float32 and
    none in int8 (the configuration's arithmetic otherwise)."""

    def replace(cfg):
        det = dict(batch_size=8)
        vis = dict(batch_size=4)
        aud = {}
        if float32:
            det["dtype"] = vis["dtype"] = aud["dtype"] = "float32"
            det["quant"] = vis["quant"] = aud["quant"] = "none"
        return dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, **det),
                                   visual=dataclasses.replace(cfg.visual, **vis),
                                   audio=dataclasses.replace(cfg.audio, **aud))

    return replace


def run(name: str, workload: str, seed: int, tmp: str, float32: bool = True) -> harness.Run:
    import torch

    return harness.Run(cell(name, workload), seed, torch.device("cpu"), tmp, wav2vec2_config(),
                       small(float32))
