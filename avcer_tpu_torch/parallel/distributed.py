"""Runs of several processes (avcer_tpu/parallel/distributed.py) over
``torch.distributed``: gloo on the CPU, NCCL between cards.

- ``initialize``: process bring-up. Explicit arguments win; otherwise the
  environment of ``torchrun`` is probed (``MASTER_ADDR`` and ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``). None given is a single-process run and a no-op;
  a partial configuration raises (one host with a typo'd variable would
  otherwise train alone, with no gradient exchange and no error); a second
  call is safe.
- serving shards whole clips (``shard_videos``: no collective crosses
  processes); training shards the corpus by file (``FileShardedSampler``),
  each process feeds its own rows, and the trainer gathers the logits for the
  global loss and sums the gradients (``gather_rows``, ``all_reduce_sum``).
- ``global_batch`` and ``local_rows`` convert between a process's rows and
  the global batch (their concatenation in process order).

Every collective here is an ``all_reduce``, which gloo also takes for CUDA
tensors: a gather is the sum of zero-filled buffers, each holding its
process's rows in place.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

_INITIALIZED = False


def _dist():
    import torch.distributed as dist

    return dist


def is_multiprocess() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return _dist().get_rank() if is_multiprocess() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_multiprocess() else 1


_index, _count = process_index, process_count


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> bool:
    """Bring up ``torch.distributed`` when a run of several processes is
    configured; a no-op (False) otherwise. ``coordinator_address``:
    ``host:port`` of process 0. ``local_device_ids``: the CUDA devices of this
    process (the first becomes current). ``backend``: default NCCL where
    CUDA is available, else gloo."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
        elif addr or port:
            coordinator_address = f"{addr or '?'}:{port or '?'}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    given = {"coordinator_address": coordinator_address, "num_processes": num_processes,
             "process_id": process_id}
    missing = [k for k, v in given.items() if v is None or (k == "coordinator_address"
                                                              and "?" in str(v))]
    if len(missing) == 3:
        return False
    if missing:
        raise ValueError(
            "multi-process config incomplete: "
            + ", ".join(f"{k}={v!r}" for k, v in given.items())
            + f" — missing {missing}. Set all three (args or MASTER_ADDR and MASTER_PORT / "
            "WORLD_SIZE / RANK) or none.")
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    _dist().init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id))
    _INITIALIZED = True
    return True


def shutdown() -> None:
    global _INITIALIZED
    if _INITIALIZED:
        _dist().destroy_process_group()
        _INITIALIZED = False


def shard_videos(paths: Sequence[str], process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> list[str]:
    """Round-robin over the sorted paths: every process computes the same
    assignment without communication, and runs its own clips."""
    pi = _index() if process_index is None else process_index
    pc = _count() if process_count is None else process_count
    return [p for i, p in enumerate(sorted(paths)) if i % pc == pi]


class FileShardedSampler:
    """A windowed corpus sharded by file across processes (each process
    opens only its own files); within the shard, batches of ``local_batch``
    local indices from a per-epoch seeded shuffle. Every process draws the
    same number of batches an epoch (the least over processes, computed from
    the file assignment alone), so the train steps run in lockstep;
    without ``drop_last`` the tail batch wraps around."""

    def __init__(self, num_samples: int, file_of, local_batch: int,
                 process_index: Optional[int] = None, process_count: Optional[int] = None,
                 seed: int = 0, drop_last: bool = True):
        self.pi = _index() if process_index is None else process_index
        self.pc = _count() if process_count is None else process_count
        self.local_batch = int(local_batch)
        self.seed = seed
        self.drop_last = drop_last
        files = sorted({file_of(i) for i in range(num_samples)})
        proc_of_file = {f: j % self.pc for j, f in enumerate(files)}
        self.local_indices = np.asarray(
            [i for i in range(num_samples) if proc_of_file[file_of(i)] == self.pi], np.int64)
        per_proc = [0] * self.pc
        for i in range(num_samples):
            per_proc[proc_of_file[file_of(i)]] += 1
        n_min = min(per_proc)
        self.batches_per_epoch = (n_min // self.local_batch if drop_last
                                  else -(-n_min // self.local_batch))

    def epoch(self, epoch: int) -> list[np.ndarray]:
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(self.local_indices)
        out = []
        for b in range(self.batches_per_epoch):
            batch = order[b * self.local_batch:(b + 1) * self.local_batch]
            if len(batch) < self.local_batch:
                batch = np.concatenate([batch, order[: self.local_batch - len(batch)]])
            out.append(batch)
        return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """In place: the sum of ``t`` over the processes (no-op alone)."""
    if is_multiprocess():
        _dist().all_reduce(t)
    return t


def _gather_buffer(t: torch.Tensor) -> torch.Tensor:
    pc, pi = process_count(), process_index()
    buf = torch.zeros((pc * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    buf[pi * t.shape[0]:(pi + 1) * t.shape[0]] = t
    return all_reduce_sum(buf)


class _GatherRows(torch.autograd.Function):
    """Forward: every process's rows, concatenated in process order.
    Backward: this process's rows of the incoming gradient. Each process
    computes the same loss of the gathered rows, so the gradient of its own
    rows is all it must pass on; the parameter gradients are then summed
    across processes."""

    @staticmethod
    def forward(ctx, t):
        ctx.rows = t.shape[0]
        return _gather_buffer(t)

    @staticmethod
    def backward(ctx, grad):
        pi = process_index()
        return grad[pi * ctx.rows:(pi + 1) * ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    """Forward and backward: the sum over the processes (a statistic that
    every process uses, such as a BatchNorm's global sums)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone())


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-process tensor; differentiable."""
    return _GatherRows.apply(t) if is_multiprocess() else t


def sum_over_processes(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over the processes."""
    return _AllReduceSum.apply(t) if is_multiprocess() else t


def global_batch(mesh, local_x) -> torch.Tensor:
    """The global batch from this process's rows (their concatenation in
    process order), on the mesh's first device; alone, the rows as they
    are."""
    t = torch.as_tensor(np.asarray(local_x)).to(mesh.first)
    return _gather_buffer(t) if is_multiprocess() else t


def local_rows(arr) -> np.ndarray:
    """This process's rows of a global batch (e.g. the train step's logits);
    alone, the whole array."""
    a = arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
    if not is_multiprocess():
        return a
    n = a.shape[0] // process_count()
    return a[process_index() * n:(process_index() + 1) * n]
