"""GPipe pipeline parallelism over the wav2vec2 encoder layer stack
(avcer_tpu/parallel/pipeline.py).

On a ``(data, pipe)`` mesh (``make_mesh_dp_pp``) each data row runs its
shard of the batch through S stages on the row's devices: stage s holds
layers [s L/S, (s+1) L/S), the batch is cut into ``n_micro`` microbatches,
and the schedule takes ``n_micro + S - 1`` ticks. At tick t stage s runs
microbatch t - s and hands its activations to stage s + 1's device (a copy
between devices, through which autograd flows back); the last stage's
outputs come back to the row's first device in the sequential path's layout.
The bubble is the usual (S - 1) / (n_micro + S - 1). The stages run in
order on the calling thread; on distinct cards their kernels overlap as far
as the launches let them.

The trainer keeps each stage's layers on the stage's device; elsewhere a
layer whose parameters sit on another device runs on differentiable copies of
them (``on_device``). ``stack_layers`` / ``unstack_layers`` give the stacked
[L, ...] layout of the JAX package for checkpoint round trips. A frozen
layer's parameters carry no gradient, so its attention takes the K2 kernel
(``models.wav2vec2.attention_route``), a trained layer's the autograd
attention. Dropout draws from one generator per stage and data row, seeded
from ``rng`` and the row's index, so rows at the same position in different
data shards draw different masks.

``wav2vec2_hidden_pipelined`` and ``expr_logits_pipelined`` run the pieces
around the stack (conv extractor, projection, positional conv; final
LayerNorm; the head) on the model's device for the whole batch, the stack
pipelined per data row. The trainer (``train.trainer``, ``mesh.pipe > 1``)
runs one replica per data row and hands each its stages through
``encoder_pipe``, which runs each layer as ``Encoder.run_layer`` does (remat
included).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn as nn
from torch.func import functional_call

from avcer_tpu_torch.models import layers
from avcer_tpu_torch.parallel.mesh import Mesh, grid, split_rows


def make_mesh_dp_pp(data: int = -1, pipe: int = 1, devices=None) -> Mesh:
    """A ``(data, pipe)`` mesh; ``data=-1`` uses all remaining devices."""
    return grid(("data", "pipe"), data, pipe, devices)


def stack_layers(encoder_params: Mapping[str, torch.Tensor], num_layers: int
                 ) -> dict[str, torch.Tensor]:
    """``{"layers.{i}.<name>": t}`` (an encoder's state dict; other keys are
    ignored) -> ``{<name>: [L, ...]}``."""
    names = sorted(k[len("layers.0."):] for k in encoder_params if k.startswith("layers.0."))
    return {n: torch.stack([encoder_params[f"layers.{i}.{n}"] for i in range(num_layers)])
            for n in names}


def unstack_layers(stacked: Mapping[str, torch.Tensor], num_layers: int) -> dict[str, torch.Tensor]:
    """Inverse of ``stack_layers``."""
    return {f"layers.{i}.{n}": t[i] for n, t in stacked.items() for i in range(num_layers)}


ENC = "wav2vec2.encoder."


def stack_encoder_params(params: Mapping[str, torch.Tensor], num_layers: int
                         ) -> dict[str, torch.Tensor]:
    """An ExprModel state dict -> the pipeline layout: the encoder layers'
    tensors merge into ``wav2vec2.encoder.layers_stacked.<name>`` of [L, ...]."""
    out = {k: v for k, v in params.items() if not k.startswith(ENC + "layers.")}
    enc = {k[len(ENC):]: v for k, v in params.items() if k.startswith(ENC + "layers.")}
    out.update({f"{ENC}layers_stacked.{n}": t for n, t in stack_layers(enc, num_layers).items()})
    return out


def unstack_encoder_params(params: Mapping[str, torch.Tensor], num_layers: int
                           ) -> dict[str, torch.Tensor]:
    """Inverse of ``stack_encoder_params``."""
    key = ENC + "layers_stacked."
    out = {k: v for k, v in params.items() if not k.startswith(key)}
    stacked = {k[len(key):]: v for k, v in params.items() if k.startswith(key)}
    out.update({ENC + k: v for k, v in unstack_layers(stacked, num_layers).items()})
    return out


def gpipe_schedule(stage_devices: Sequence[torch.device],
                   stage_fn: Callable[[int, torch.Tensor], torch.Tensor],
                   h: torch.Tensor, n_micro: int) -> torch.Tensor:
    """The GPipe schedule of ``stage_fn(s, x)`` over ``h``'s ``n_micro``
    microbatches; the result on ``h``'s device. Stages run last to first
    within a tick, so each reads what its predecessor handed over the tick
    before."""
    n_stages = len(stage_devices)
    mbs = split_rows(h, n_micro, "a microbatched batch") if n_micro > 1 else [h]
    outs: list = [None] * n_micro
    inbox: list = [None] * n_stages
    for tick in range(n_micro + n_stages - 1):
        for s in reversed(range(n_stages)):
            m = tick - s
            if not 0 <= m < n_micro:
                continue
            x = mbs[m].to(stage_devices[0]) if s == 0 else inbox[s]
            y = stage_fn(s, x)
            if s == n_stages - 1:
                outs[m] = y.to(h.device)
            else:
                inbox[s + 1] = y.to(stage_devices[s + 1])
    return torch.cat(outs) if n_micro > 1 else outs[0]


class _Run(nn.Module):
    def __init__(self, layer: nn.Module, run: Callable):
        super().__init__()
        self.layer = layer
        self.run = run

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(self.layer, x)


def on_device(layer: nn.Module, x: torch.Tensor, run: Callable = None,
              params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    """``run(layer, x)`` with the layer's parameters (or ``params``) as
    differentiable copies on ``x``'s device."""
    run = run or (lambda mod, inp: mod(inp))
    named = dict(params if params is not None else layer.named_parameters())
    if params is None and all(t.device == x.device for t in named.values()):
        return run(layer, x)
    return functional_call(_Run(layer, run), {f"layer.{n}": t.to(x.device)
                                              for n, t in named.items()}, (x,))


def stage_generators(devices: Sequence[torch.device], seed: int, row: int
                     ) -> list[torch.Generator]:
    """One dropout generator a stage of data row ``row``."""
    return [torch.Generator(device=d).manual_seed(seed * 1_000_003 + row * 1009 + s)
            for s, d in enumerate(devices)]


def check_stages(num_layers: int, n_stages: int) -> int:
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} layers do not divide over {n_stages} stages")
    return num_layers // n_stages


def encoder_pipe(stage_devices: Sequence[torch.device], n_micro: int,
                 generators: Optional[Sequence[torch.Generator]] = None) -> Callable:
    """The ``Encoder.pipe`` hook of one data row: the encoder's own layers
    over ``stage_devices`` in the GPipe schedule (each layer as
    ``Encoder.run_layer`` runs it, so a trained layer is recomputed in the
    backward pass under ``remat``)."""

    def run(encoder: nn.Module, h: torch.Tensor) -> torch.Tensor:
        per = check_stages(len(encoder.layers), len(stage_devices))

        def stage_fn(s: int, x: torch.Tensor) -> torch.Tensor:
            for layer in encoder.layers[s * per:(s + 1) * per]:
                if generators is not None:
                    layers.set_dropout(layer, generator=generators[s])
                x = on_device(layer, x, encoder.run_layer)
            return x

        return gpipe_schedule(stage_devices, stage_fn, h, n_micro)

    return run


def _check_axes(mesh: Mesh) -> None:
    if "pipe" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'pipe' axis")
    if "data" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'data' axis")


def _rows(mesh: Mesh, h: torch.Tensor, n_micro: int) -> list[torch.Tensor]:
    _check_axes(mesh)
    if h.shape[0] % (mesh.local_data * n_micro):
        raise ValueError(f"batch {h.shape[0]} must divide data={mesh.local_data} x "
                         f"n_micro={n_micro}")
    return split_rows(h, mesh.local_data)


def gpipe_apply(mesh: Mesh, layer_module: nn.Module, stacked_params: Mapping[str, torch.Tensor],
                h: torch.Tensor, n_micro: int, deterministic: bool = True,
                rng: Optional[int] = None) -> torch.Tensor:
    """``layer_module`` applied L times (``stacked_params``: ``{name: [L,
    ...]}``), pipelined over the mesh's "pipe" axis per data row; the same
    math as ``for i in range(L): h = layer_i(h)``. ``rng``: a seed for the
    dropout masks when not ``deterministic``."""
    _check_axes(mesh)
    num_layers = next(iter(stacked_params.values())).shape[0]
    per = check_stages(num_layers, mesh.shape["pipe"])
    layer_module.train(not deterministic)
    outs = []
    for d, hd in enumerate(_rows(mesh, h, n_micro)):
        devs = mesh.row(d)
        gens = (stage_generators(devs, int(rng), mesh.process_index * mesh.local_data + d)
                if not deterministic and rng is not None else None)

        def stage_fn(s: int, x: torch.Tensor) -> torch.Tensor:
            if gens is not None:
                layers.set_dropout(layer_module, generator=gens[s])
            for li in range(s * per, (s + 1) * per):
                x = on_device(layer_module, x, params={n: t[li] for n, t in stacked_params.items()})
            return x

        outs.append(gpipe_schedule(devs, stage_fn, hd, n_micro).to(h.device))
    return torch.cat(outs)


def _pipelined(encoder: nn.Module, mesh: Mesh, n_micro: int, rng: Optional[int],
               training: bool) -> Callable:
    def run(enc: nn.Module, h: torch.Tensor) -> torch.Tensor:
        outs = []
        for d, hd in enumerate(_rows(mesh, h, n_micro)):
            devs = mesh.row(d)
            gens = (stage_generators(devs, int(rng), mesh.process_index * mesh.local_data + d)
                    if training and rng is not None else None)
            outs.append(encoder_pipe(devs, n_micro, gens)(enc, hd).to(h.device))
        return torch.cat(outs)

    return run


def wav2vec2_hidden_pipelined(w2v: nn.Module, wav: torch.Tensor, mesh: Mesh, n_micro: int,
                              deterministic: bool = True, rng: Optional[int] = None
                              ) -> torch.Tensor:
    """The wav2vec2 forward with its layer stack pipelined: same parameters
    and the same math as ``w2v(wav)``."""
    if w2v.config.quant:
        raise ValueError("pipeline parallelism is a training/serving-exact path; int8 "
                         "act_scales are not threaded through it")
    w2v.train(not deterministic)
    enc = w2v.encoder
    enc.pipe = _pipelined(enc, mesh, n_micro, rng, not deterministic)
    try:
        return w2v(wav)
    finally:
        enc.pipe = None


def expr_logits_pipelined(model: nn.Module, wav: torch.Tensor, mesh: Mesh, n_micro: int,
                          deterministic: bool = True, rng: Optional[int] = None, **kw):
    """ExprModel forward with the encoder's layer stack pipelined and the
    head on the model's device; ``kw`` passes on (``return_features``)."""
    h = wav2vec2_hidden_pipelined(model.wav2vec2, wav, mesh, n_micro, deterministic, rng)
    model.train(not deterministic)
    return model.head(h, **kw)


def expr_logits_stacked(model: nn.Module, params: Mapping[str, torch.Tensor], wav: torch.Tensor,
                        mesh: Mesh, n_micro: int, deterministic: bool = True,
                        rng: Optional[int] = None, **kw):
    """``expr_logits_pipelined`` from the stacked layout of
    ``stack_encoder_params`` (buffers come from ``model``)."""
    num_layers = len(model.wav2vec2.encoder.layers)
    named = unstack_encoder_params(params, num_layers)

    class _Fwd(nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, x):
            return expr_logits_pipelined(self.model, x, mesh, n_micro, deterministic, rng, **kw)

    return functional_call(_Fwd(), {f"model.{k}": v for k, v in named.items()}, (wav,))
