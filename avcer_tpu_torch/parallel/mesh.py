"""Device mesh and tensor-parallel rules (avcer_tpu/parallel/mesh.py).

A mesh is a grid of ``torch.device`` with named axes, ``("data", "model")``
from ``make_mesh`` or ``("data", "pipe")`` from ``parallel.pipeline``:

- **data**: the batch splits into equal shards along the first axis; each
  shard runs on a replica of the model on its device, and the results come
  back to the mesh's first device. Serving keeps one replica of the weights
  a device (``pipeline.detect``, ``pipeline.visual``); training keeps the
  master weights and the optimizer in the first replica, refreshes the
  others from it after every update, and sums their gradients into it after
  the backward pass (``train.trainer``).
- **model**: tensor parallelism of the wav2vec2 encoder and the heads'
  transformer layers, the Megatron split of the JAX package's rules on the
  port's (the reference's torch) parameter names. A torch ``Linear`` stores
  ``[out, in]``: a column-parallel layer splits dim 0 of its weight and its
  bias, a row-parallel layer dim 1 of its weight; the row-parallel partial
  products are summed on the row's first device (``layers.TensorParallel``),
  and the sum carries its gradient.

In a run of several processes (``parallel.distributed``) each process holds
its rows of the global data axis: ``make_mesh`` counts the devices of every
process, as ``jax.devices()`` does, and keeps the local ones. The devices of
a mesh come from the CUDA devices by default; an explicit ``devices=`` list
may name one device several times (``["cpu"] * 2`` in the CPU tests, one card
twice on a machine with one), the counterpart of the virtual CPU devices the
JAX tests use.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from avcer_tpu_torch.parallel import distributed


class Mesh:
    """This process's rows of a device grid. ``devices``: ``[local rows,
    ...]`` of ``torch.device``; ``shape``: the global size of each axis (the
    first axis counts the rows of every process)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 process_count: int = 1, process_index: int = 0):
        self.devices = devices
        self.axis_names = axis_names
        self.process_count = process_count
        self.process_index = process_index

    @property
    def shape(self) -> dict[str, int]:
        dims = list(self.devices.shape)
        dims[0] *= self.process_count
        return dict(zip(self.axis_names, dims))

    @property
    def local_data(self) -> int:
        return self.devices.shape[0]

    @property
    def first(self) -> torch.device:
        return self.devices.flat[0]

    def row(self, i: int) -> list[torch.device]:
        """The devices of local data row ``i`` (its model or pipe axis)."""
        return list(self.devices[i])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def default_devices(kind: str = "cuda") -> list[torch.device]:
    """Every device of this process of ``kind``: each CUDA device, or the
    one CPU."""
    if torch.device(kind).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def grid(axis_names: tuple[str, str], first: int, second: int,
         devices: Optional[Sequence] = None) -> Mesh:
    """A two-axis mesh over ``devices`` (default: every CUDA device) and the
    devices of the other processes; ``first == -1`` takes all that remain.
    Raises ``ValueError("mesh DxM exceeds N devices")`` as the JAX package
    does."""
    local = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    pc, pi = distributed.process_count(), distributed.process_index()
    n = len(local) * pc
    if first == -1:
        first = n // second
    if first * second > n:
        raise ValueError(f"mesh {first}x{second} exceeds {n} devices")
    if first % pc:
        raise ValueError(f"the {axis_names[0]} axis {first} does not divide over {pc} processes")
    rows = first // pc
    cells = np.empty((rows, second), dtype=object)
    for i, dev in enumerate(local[: rows * second]):
        cells[i // second, i % second] = dev
    return Mesh(cells, axis_names, pc, pi)


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh; ``data=-1`` uses all remaining devices."""
    return grid(("data", "model"), data, model, devices)


#: parameter-name pattern -> the dim of the torch weight the "model" axis
#: splits (0: column-parallel, out features; 1: row-parallel, in features)
TP_RULES: list[tuple[str, int]] = [
    (r".*attention\.[qkv]_proj\.weight$", 0),
    (r".*attention\.[qkv]_proj\.bias$", 0),
    (r".*intermediate_dense\.weight$", 0),
    (r".*intermediate_dense\.bias$", 0),
    (r".*attention\.out_proj\.weight$", 1),
    (r".*output_dense\.weight$", 1),
    (r".*self_attention\.(query_w|keys_w|values_w)\.weight$", 0),
    (r".*self_attention\.ff_layer_after_concat\.weight$", 1),
    (r".*feed_forward\.layer_1\.weight$", 0),
    (r".*feed_forward\.layer_1\.bias$", 0),
    (r".*feed_forward\.layer_2\.weight$", 1),
]


def spec_for(name: str) -> Optional[int]:
    """The split dim of parameter ``name`` under the rules, None to replicate."""
    return next((dim for pattern, dim in TP_RULES if re.match(pattern, name)), None)


def param_specs(named: Iterable[tuple[str, torch.Tensor]], mesh: Mesh) -> dict[str, Optional[int]]:
    """``{name: split dim or None}`` under the rules; a dim the model axis
    does not divide falls back to replication, as in the JAX package."""
    m = mesh.shape.get("model", 1)
    out = {}
    for name, t in named:
        dim = spec_for(name) if m > 1 else None
        out[name] = dim if dim is not None and t.shape[dim] % m == 0 else None
    return out


def tensor_parallel_modules(model: torch.nn.Module, specs: Mapping[str, Optional[int]],
                            model_size: int) -> list[tuple[str, torch.nn.Module]]:
    """The modules of ``model`` that run split over the model axis: those
    with a ``tp_names`` tuple (their parameters under the rules) whose every
    parameter the rules split, and whose heads (if any) the axis divides. A
    module with one of them replicated runs whole on the row's first device
    (the same function)."""
    out = []
    for path, mod in model.named_modules():
        names = getattr(mod, "tp_names", None)
        split = names and all(specs.get(f"{path}.{n}") is not None for n in names)
        if split and getattr(mod, "num_heads", model_size) % model_size == 0:
            out.append((path, mod))
    return out


class ReplicaGroup:
    """The data-parallel replicas of one process, each on its own thread
    (``parallel_apply``): ``all_sum`` is the sum of a tensor over the
    replicas, and with ``processes`` over every process's replicas too,
    differentiable, returned on each caller's device. A BatchNorm in training
    takes its global batch statistics through it (``layers.BatchNorm.sync``)."""

    def __init__(self, n: int, processes: bool = False):
        self.n = n
        self.processes = processes
        self.barrier = threading.Barrier(n, timeout=600)
        self.slots: list = [None] * n
        self.total = None

    def all_sum(self, i: int, t: torch.Tensor) -> torch.Tensor:
        self.slots[i] = t
        self.barrier.wait()
        if i == 0:
            total = self.slots[0]
            for s in self.slots[1:]:
                total = total + s.to(total.device)
            self.total = distributed.sum_over_processes(total) if self.processes else total
        self.barrier.wait()
        out = self.total.to(t.device)
        self.barrier.wait()
        return out


def parallel_apply(fns: Sequence[Callable[[], object]], on_error: Callable[[], None] = lambda: None
                   ) -> list:
    """Run ``fns`` at once, one thread each past the first (which runs on the
    calling thread), with the caller's grad mode and autocast state; returns
    their results in order. Where one raises, ``on_error`` runs (it breaks
    the barriers the others may wait at) and the first error is raised."""
    if len(fns) == 1:
        return [fns[0]()]
    grad = torch.is_grad_enabled()
    casts = [(kind, torch.get_autocast_dtype(kind)) for kind in ("cpu", "cuda")
             if torch.is_autocast_enabled(kind)]
    results: list = [None] * len(fns)
    errors: list = [None] * len(fns)

    def run(i: int) -> None:
        try:
            with torch.set_grad_enabled(grad), _autocasts(casts):
                results[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            errors[i] = e
            on_error()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(1, len(fns))]
    for t in threads:
        t.start()
    run(0)
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None and not isinstance(
        e, threading.BrokenBarrierError)), next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results


class _autocasts:
    def __init__(self, casts):
        self.ctx = [torch.autocast(kind, dtype=dtype) for kind, dtype in casts]

    def __enter__(self):
        for c in self.ctx:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctx):
            c.__exit__(*exc)
        return False


def split_rows(x: torch.Tensor, n: int, what: str = "batch") -> list[torch.Tensor]:
    """``x`` in ``n`` equal shards along dim 0; raises where ``n`` does not
    divide it, as the JAX package's ``device_put`` onto a sharded batch does."""
    if x.shape[0] % n:
        raise ValueError(f"{what} of {x.shape[0]} rows does not divide over the data axis "
                         f"of {n} devices")
    return list(x.chunk(n)) if n > 1 else [x]
