"""Simulation of a run of several processes on the CPU
(avcer_tpu/parallel/launch_sim.py), over gloo.

The launcher starts N worker processes (default 2), each with 4 CPU devices
(``["cpu"] * 4``); every worker runs

1. ``distributed.initialize`` against process 0's address;
2. a global ``(data=4, model=2)`` mesh over the 8 devices of both processes:
   the data axis spans the processes, so the gradients' all-reduce (and the
   logits' gather, and the BatchNorms' global statistics) cross the process
   boundary;
3. ``FileShardedSampler`` over a synthetic windowed corpus (disjoint shards
   by file);
4. two train steps of a tiny ExprModel V3 through ``Trainer`` (bf16 compute
   over f32 master weights, each process feeding its own rows) and an eval
   step;
5. ``shard_videos``, disjoint and exhaustive.

Run: ``python -m avcer_tpu_torch.parallel.launch_sim [--processes 2]``. Each
worker prints one JSON line; the launcher checks the exit codes, that the
processes' losses agree (one global loss) and that their clips tile the
list, and prints a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

LOCAL_DEVICES = 4
N_VIDEOS = 7


def worker(process_id: int, num_processes: int, port: int) -> dict:
    import numpy as np
    import torch

    torch.set_num_threads(2)
    from avcer_tpu_torch.core.config import MeshConfig, OptimConfig, TrainConfig
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from avcer_tpu_torch.parallel import distributed
    from avcer_tpu_torch.parallel import mesh as mesh_lib
    from avcer_tpu_torch.train.trainer import Trainer

    assert distributed.initialize(coordinator_address=f"localhost:{port}",
                                  num_processes=num_processes, process_id=process_id,
                                  backend="gloo")
    assert distributed.process_count() == num_processes
    try:
        videos = [f"clip_{i:03d}.mp4" for i in range(N_VIDEOS)]
        mine = distributed.shard_videos(videos)
        counts = [len(distributed.shard_videos(videos, p, num_processes))
                  for p in range(num_processes)]
        assert sum(counts) == len(videos)

        mesh = mesh_lib.make_mesh(data=4, model=2, devices=["cpu"] * LOCAL_DEVICES)
        assert mesh.shape == {"data": 4, "model": 2} and mesh.local_data == 4 // num_processes
        w2v2 = Wav2Vec2Config(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                              conv_dim=(16,) * 7)
        cfg = TrainConfig(batch_size=8, epochs=1, mesh=MeshConfig(data=4, model=2),
                          optim=OptimConfig(lr=1e-3),
                          log_root=tempfile.mkdtemp(prefix="avcer_sim_logs_"))
        trainer = Trainer(ExprModel("v3", 8, w2v2), cfg, iters_per_epoch=2, unfreeze_last_n=1,
                          wav2vec2_layers=2, mesh=mesh, device="cpu", dtype="bfloat16")

        rng = np.random.default_rng(0)
        n_samples, n_files = 24, 6
        wavs = rng.normal(size=(n_samples, 17600)).astype(np.float32) * 0.1
        labels = rng.integers(0, 8, n_samples)

        def file_of(i):
            return f"file_{i // (n_samples // n_files)}"

        local_batch = 8 // num_processes
        sampler = distributed.FileShardedSampler(n_samples, file_of, local_batch=local_batch,
                                                 seed=0)
        other = distributed.FileShardedSampler(
            n_samples, file_of, local_batch=local_batch,
            process_index=(process_id + 1) % num_processes, process_count=num_processes, seed=0)
        assert not set(sampler.local_indices) & set(other.local_indices)

        state = trainer.init_state()
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
        losses = []
        for batch_idx in sampler.epoch(0)[:2]:
            state, loss, logits = trainer.train_step(state, wavs[batch_idx], labels[batch_idx])
            losses.append(loss)
            local = distributed.local_rows(logits)
            assert logits.shape == (8, 8) and local.shape == (local_batch, 8), local.shape
        eval_idx = sampler.epoch(1)[0]
        eval_logits, eval_loss = trainer.eval_step(state, wavs[eval_idx], labels[eval_idx])
        assert eval_logits.shape == (local_batch, 8)
        return {"process_id": process_id, "local_videos": len(mine),
                "local_samples": int(sampler.local_indices.size),
                "batches_per_epoch": sampler.batches_per_epoch,
                "losses": losses, "eval_loss": eval_loss}
    finally:
        distributed.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--port", type=int, default=None, help="default: a free local port")
    p.add_argument("--worker", type=int, default=None, help="internal")
    args = p.parse_args(argv)
    port = args.port or free_port()
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.processes, port)))
        return 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "avcer_tpu_torch.parallel.launch_sim", "--worker", str(i),
         "--processes", str(args.processes), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for i in range(args.processes)]
    reports, failed = [], False
    try:
        for i, proc in enumerate(procs):
            out, err = proc.communicate(timeout=1200)
            if proc.returncode != 0:
                sys.stderr.write(f"worker {i} failed:\n{err[-4000:]}\n")
                failed = True
                continue
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        return 1
    losses = {tuple(r["losses"]) for r in reports}
    assert len(losses) == 1, f"processes diverged: {losses}"
    assert sum(r["local_videos"] for r in reports) == N_VIDEOS
    print(json.dumps({"ok": True, "processes": args.processes, "losses": reports[0]["losses"],
                      "eval_loss": reports[0]["eval_loss"],
                      "local_samples": [r["local_samples"] for r in reports]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
