"""The reference's shared parts: where a forward pass takes its parameters
(``Ctx``), the convolutions, products, norms and attention every model
family is written in, and the loading of a configuration's families.

A configuration file's ``models`` block names, for each role of the pipeline
(``detector``, ``static``, ``dynamic``, ``audio``: see ``clip.Reference``),
the file under ``perfbench/reference/families/`` that computes it and the
published shape that file takes::

    "models": {"audio": {"module": "wav2vec2_expr_v3", "shape": {"num_layers": 12, ...}}}

Every family file keeps one interface: ``PROGRAM_CLASS``, the name of the
program's model class whose state dict the family's parameters fill;
``forward(ctx, x, shape, quant=False)``, the plain float32 forward;
``example(shape, device)``, the smallest input that reads every parameter.
The audio family also gives the pieces that the shared extractor and the
work counts use: ``features``, ``encode``, ``head``, ``frames_per_window``
and ``hop``. No size of a model is written in code: each comes from its
shape.

Everything runs in float32 on whatever device the inputs are on. Parameter
names are those of the published torch modules, so that one dict of tensors
serves as the state dict of any implementation that keeps them.

A ``Ctx`` says where parameters come from: in spec mode a forward records
each name, shape and kind and computes on zeros (on the ``meta`` device it
computes nothing); otherwise it reads them from ``weights``. ``calibrate``
makes every BatchNorm take its input's batch statistics as its running ones,
in place in ``weights``. ``quant`` replaces the convolutions and products that
an int8 serving configuration quantises (each family's docstring says which)
by a function of the caller's, for a lower-precision control or for counting
operations.

This module imports torch and nothing of the program it checks.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
from types import ModuleType
from typing import Callable, Optional

import torch
import torch.nn.functional as F


class Ctx:
    """Where a forward pass takes its parameters (see the module docstring)."""

    def __init__(self, weights: Optional[dict] = None, calibrate: bool = False,
                 quant: Optional[Callable] = None):
        self.weights = weights
        self.spec: Optional[list] = [] if weights is None else None
        self.calibrate = calibrate
        self.quant = quant

    def p(self, name: str, shape: tuple, kind: str, like: torch.Tensor) -> torch.Tensor:
        if self.spec is not None:
            self.spec.append((name, tuple(int(s) for s in shape), kind))
            if kind == "count":
                return torch.zeros((), dtype=torch.long, device=like.device)
            fill = 1.0 if kind in ("bn_weight", "bn_residual", "bn_var", "ln_weight") else 0.0
            return torch.full(shape, fill, dtype=torch.float32, device=like.device)
        return self.weights[name]


def conv2d(ctx: Ctx, name: str, x: torch.Tensor, cout: int, k: int, stride: int = 1,
           padding: int = 0, groups: int = 1, bias: bool = False,
           quant: bool = False) -> torch.Tensor:
    w = ctx.p(name + ".weight", (cout, x.shape[1] // groups, k, k), "kernel", x)
    b = ctx.p(name + ".bias", (cout,), "bias", x) if bias else None
    kw = dict(stride=stride, padding=padding, groups=groups)
    if quant and ctx.quant is not None:
        return ctx.quant(F.conv2d, x, w, b, kw)
    return F.conv2d(x, w, b, **kw)


def conv1d(ctx: Ctx, name: str, x: torch.Tensor, cout: int, k: int, stride: int = 1,
           padding: int = 0, groups: int = 1, dilation: int = 1, bias: bool = True,
           quant: bool = False) -> torch.Tensor:
    w = ctx.p(name + ".weight", (cout, x.shape[1] // groups, k), "kernel", x)
    b = ctx.p(name + ".bias", (cout,), "bias", x) if bias else None
    kw = dict(stride=stride, padding=padding, groups=groups, dilation=dilation)
    if quant and ctx.quant is not None:
        return ctx.quant(F.conv1d, x, w, b, kw)
    return F.conv1d(x, w, b, **kw)


def linear(ctx: Ctx, name: str, x: torch.Tensor, cout: int, bias: bool = True,
           quant: bool = False) -> torch.Tensor:
    w = ctx.p(name + ".weight", (cout, x.shape[-1]), "kernel", x)
    b = ctx.p(name + ".bias", (cout,), "bias", x) if bias else None
    if quant and ctx.quant is not None:
        return ctx.quant(F.linear, x, w, b, {})
    return F.linear(x, w, b)


def batch_norm(ctx: Ctx, name: str, x: torch.Tensor, eps: float,
               residual: bool = False) -> torch.Tensor:
    """Inference BatchNorm over dim 1; with ``ctx.calibrate`` the running
    statistics first become the batch's (biased variance). ``residual``
    marks the last BatchNorm of a residual branch (its scale's kind is
    ``bn_residual``)."""
    c = x.shape[1]
    w = ctx.p(name + ".weight", (c,), "bn_residual" if residual else "bn_weight", x)
    b = ctx.p(name + ".bias", (c,), "bn_bias", x)
    mean = ctx.p(name + ".running_mean", (c,), "bn_mean", x)
    var = ctx.p(name + ".running_var", (c,), "bn_var", x)
    ctx.p(name + ".num_batches_tracked", (), "count", x)
    if ctx.calibrate:
        dims = [0] + list(range(2, x.dim()))
        mean.copy_(x.mean(dims))
        var.copy_(x.var(dims, unbiased=False))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var + eps) * w
    return x * inv.view(shape) + (b - mean * inv).view(shape)


def layer_norm(ctx: Ctx, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    c = x.shape[-1]
    return F.layer_norm(x, (c,), ctx.p(name + ".weight", (c,), "ln_weight", x),
                        ctx.p(name + ".bias", (c,), "ln_bias", x), eps)


def act(x: torch.Tensor, leaky: Optional[float]) -> torch.Tensor:
    """None: none; 0: ReLU; else leaky ReLU with that slope."""
    if leaky is None:
        return x
    return F.relu(x) if leaky == 0.0 else F.leaky_relu(x, leaky)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax attention of [B, T, D] over ``heads`` heads of D / heads."""
    b, t, d = q.shape

    def split(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(b, t, heads, d // heads).transpose(1, 2)

    logits = split(q) @ split(k).transpose(-1, -2) / math.sqrt(d // heads)
    out = torch.softmax(logits, dim=-1) @ split(v)
    return out.transpose(1, 2).reshape(b, t, d)


# ---------------------------------------------------------------------------
# model families
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Family:
    """One model of a configuration: its role, the family file's name, the
    shape it takes and the loaded file. Compared and hashed by identity."""

    role: str
    name: str
    shape: dict
    module: ModuleType

    @property
    def program_class(self) -> str:
        return self.module.PROGRAM_CLASS

    def forward(self, ctx: Ctx, x: torch.Tensor, quant: bool = False):
        return self.module.forward(ctx, x, self.shape, quant)

    def spec(self) -> list:
        """[(name, shape, kind)] of every parameter and buffer the family's
        state dict holds, in the order its forward reads them."""
        ctx = Ctx()
        self.forward(ctx, self.module.example(self.shape, torch.device("meta")))
        return ctx.spec


def load_families(block: dict, root: str) -> dict:
    """{role: Family} of a configuration's ``models`` block, in its order,
    each file found by name under ``root/perfbench/reference/families/``."""
    out = {}
    for role, entry in block.items():
        name = entry["module"]
        path = os.path.join(root, "perfbench", "reference", "families", name + ".py")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"model family {name!r} of role {role!r}: no {path}")
        spec = importlib.util.spec_from_file_location("perfbench_family_" + name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out[role] = Family(role, name, dict(entry["shape"]), module)
    return out
