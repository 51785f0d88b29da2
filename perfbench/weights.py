"""The weights of a run, made from ``--seed`` on the device in a few large
draws, and handed to both sides: the program (as its state dicts) and the
reference.

Each role's parameters are those its family's published module holds
(``models.Family.spec``), drawn in the order of the configuration's
``models`` block. One normal draw a family covers them all:
kernels get variance 1 / fan_in; conv and linear biases 0.02 z; norm
scales 1 + 0.1 z and shifts 0.1 z, but the last BatchNorm of each residual
branch scales by 0.1 (1 + 0.1 z), as a trained ResNet's branches add small
corrections to the identity (and a network whose fifty layers each
multiply a perturbation is chaotic: float32 and bfloat16 would part by a
fifth of the features, and a lower precision could not be told from it,
where a trained one parts by a per cent). Every BatchNorm's running
statistics are then set to the statistics of its input on the run's own
frames, crops, the crops' features and windows (one forward of the
reference a family, as a trained network's BatchNorms normalise what they
see), so that activations keep their scale through fifty layers and the
detector's scores and boxes stay in range. Every value is rounded to a
bfloat16 value, so that both sides hold the very same numbers whichever
dtype serves them.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import models as M
from perfbench.reference import pipeline as P
from perfbench.reference.clip import exact_float32

#: the scale of the last BatchNorm of a residual branch
RESIDUAL_SCALE = 0.1


def draw(spec: list, gen: torch.Generator, device) -> dict:
    """Values for every entry of ``spec`` from one normal draw."""
    floats = [(n, s, k) for n, s, k in spec if k != "count"]
    total = sum(int(np.prod(s)) for _, s, _ in floats)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = int(np.prod(shape))
        v = z[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            v = v * (1.0 / float(np.prod(shape[1:]))) ** 0.5
        elif kind == "bias":
            v = v * 0.02
        elif kind in ("bn_weight", "ln_weight"):
            v = 1.0 + 0.1 * v
        elif kind == "bn_residual":
            v = RESIDUAL_SCALE * (1.0 + 0.1 * v)
        elif kind in ("bn_bias", "ln_bias"):
            v = 0.1 * v
        elif kind == "bn_mean":
            v = torch.zeros_like(v)
        elif kind == "bn_var":
            v = torch.ones_like(v)
        else:
            raise ValueError(f"no rule for {name} ({kind})")
        out[name] = v.to(torch.bfloat16).float()
    return out


def to_bf16_values(weights: dict) -> None:
    for name, v in weights.items():
        if v.is_floating_point():
            weights[name] = v.to(torch.bfloat16).float()


@torch.no_grad()
def make(seed: int, serving: dict, traffic, device, families: dict) -> dict:
    """{role: {name: float32 tensor on ``device``}} for a run of ``seed``
    under the configuration's ``serving`` switches and ``families`` ({role:
    ``models.Family``}), its BatchNorms set on ``traffic``'s own frames,
    crops and wav."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    weights = {role: draw(fam.spec(), gen, device) for role, fam in families.items()}

    def calibrate(role: str, x: torch.Tensor):
        return families[role].forward(M.Ctx(weights[role], calibrate=True), x)

    n = traffic.frames.shape[0]
    pick = np.array([0, n // 2])
    with exact_float32():
        wire, scale = P.wire_frames(torch.from_numpy(traffic.frames[pick]).to(device),
                                    serving["long_side"])
        mean = torch.tensor(P.RETINAFACE_MEAN, device=device)
        calibrate("detector", wire.float() - mean)
        pick = np.linspace(0, n - 1, 8).astype(np.int64)
        wire, _ = P.wire_frames(torch.from_numpy(traffic.frames[pick]).to(device),
                                serving["long_side"])
        nh, nw = wire.shape[1:3]
        w, h = traffic.frames.shape[2], traffic.frames.shape[1]
        _, lb = P.crop_boxes(traffic.boxes[pick], w, h, scale, nh, nw)
        crops = P.crops(wire, torch.from_numpy(lb).to(device)).float()
        _, feats = calibrate("static", crops - torch.tensor(P.VGGFACE2_MEAN, device=device))
        calibrate("dynamic", feats[None])  # the crops' features as one sequence
        size = min(64000, len(traffic.wav) - 8000)
        wav = torch.from_numpy(traffic.wav[:size + 8000]).to(device)
        win = P.normalise(torch.stack([wav[:size], wav[8000:8000 + size]]))
        calibrate("audio", win)
    for sd in weights.values():
        to_bf16_values(sd)
    return weights


def to_host(weights: dict) -> dict:
    return {f: {k: v.cpu() for k, v in sd.items()} for f, sd in weights.items()}


def to_device(weights: dict, device) -> dict:
    return {f: {k: v.to(device) for k, v in sd.items()} for f, sd in weights.items()}
