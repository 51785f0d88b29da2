"""One run of one cell: set-up, the measured window, the traced clips, the
check against the reference, and the result line.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one cell's limits is a file of its own, found by the
name ``BENCHMARK.json`` gives it: ``configs/<config>.json`` (through the
configuration's ``file``), ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<workload>.json``.

The window is a closed loop of one client: clip after clip, each served as
``cli.run --path_video clip`` serves it (``Pipeline.run`` with the outputs
written), until the first clip that ends after ``--seconds``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules no run may hold: JAX, its libraries, the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "avcer_tpu")


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list  # (metric entry, reader module)
    w2v: dict = field(default_factory=dict)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_reader(root: str, name: str):
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and every file it names."""
    from perfbench.reference import models as M

    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    mix = load_json(os.path.join(root, "perfbench", "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(root, "perfbench", "limits", name + ".json"))["limits"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [(m, metric_reader(root, m["name"])) for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"], config=config, mix=mix, limits=limits,
                end_to_end=e2e, per_layer=per_layer, w2v=dict(M.W2V2))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    import subprocess

    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = "not measured"
    return info


def set_caches(root: str) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    from avcer_tpu_torch import _build

    cache = os.path.join(root, "build", "perfbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    _build.set_cache_dir(os.path.join(cache, "kernels"))


class GcPauses:
    """The Python collector's pauses while it is entered: their count, the
    count of the oldest generation's, and their seconds."""

    def __init__(self):
        self.n = self.n_old = 0
        self.seconds = 0.0
        self._t = 0.0

    def _on(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t
            self.n += 1
            self.n_old += info.get("generation") == 2

    def __enter__(self):
        gc.callbacks.append(self._on)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on)

    def summary(self) -> dict:
        return {"collections": self.n, "oldest": self.n_old, "seconds": self.seconds}


class Run:
    """The state of one run, step by step (``main`` drives it; tests drive
    the steps on the CPU with a small cell)."""

    def __init__(self, cell: Cell, seed: int, device, out_dir: str, wav2vec2_config=None,
                 config_replace=None):
        from perfbench import program, weights
        from perfbench.traffic import Traffic

        self.cell, self.seed, self.device = cell, seed, device
        self.out_dir = out_dir
        self.traffic = Traffic(cell.mix, seed)
        cfg = program.pipeline_config(cell.config, program.no_weights_dir(out_dir))
        #: the serving switches as the configuration file states them, for
        #: the weights, the reference and the work counts. They are a frozen
        #: copy of what the CLI maps the argv to, not read from the program:
        #: a program whose mapping drifts is then held against the
        #: configuration as stated, and a test pins the two together. A test
        #: that shrinks the program's batches takes its switches from the
        #: program it built.
        self.serving = dict(cell.config["serving"])
        if config_replace is not None:
            cfg = config_replace(cfg)
            self.serving = program.serving_of(cfg)
        w = weights.make(seed, self.serving, self.traffic, device, cell.w2v)
        self.weights_host = weights.to_host(w)
        del w
        self.program = program.Program(program.build(cfg, self.weights_host, device,
                                                     wav2vec2_config))
        self.records: list[dict] = []
        self.failed = 0
        self.instruments = None
        self.profile = None

    def serve(self, clip) -> dict:
        t0 = time.perf_counter()
        try:
            served = self.program.serve(clip, self.out_dir)
        except Exception:  # noqa: BLE001 - a failed clip is counted, the window goes on
            traceback.print_exc(file=sys.stderr)
            self.failed += 1
            served = None
        return {"clip": clip, "served": served, "wall": time.perf_counter() - t0}

    def warm_up(self) -> None:
        for clip in self.traffic.warmup_clips():
            rec = self.serve(clip)
            if rec["served"] is None:
                raise RuntimeError("a warm-up clip failed")
        self.failed = 0

    def window(self, seconds: float) -> dict:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        pauses = GcPauses()
        t0 = time.perf_counter()
        k = 0
        with pauses:
            while True:
                rec = self.serve(self.traffic.clip(k))
                self.records.append(rec)
                k += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        elapsed = time.perf_counter() - t0
        done = [r for r in self.records if r["served"] is not None]
        return {"seconds": elapsed, "video_s": sum(r["clip"].video_seconds for r in done),
                "walls": [r["wall"] for r in self.records], "gc": pauses.summary()}

    def traced_clips(self, n: int) -> None:
        """``n`` more whole clips under ``torch.profiler`` (CPU and CUDA), the
        events kept in memory."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from perfbench.spans import PREFIX, Profile

        self.instruments.ranges = True
        clips = [self.traffic.clip(len(self.records) + i) for i in range(n)]
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities) as prof:
            with record_function(PREFIX + "audio_stream"):
                with torch.cuda.stream(self.program.pipe._audio_stream):
                    torch.zeros(1, device=self.device)
                torch.cuda.synchronize(self.device)
            for clip in clips:
                with record_function(PREFIX + "clip"):
                    rec = self.serve(clip)
                if rec["served"] is None:
                    raise RuntimeError("a traced clip failed")
            torch.cuda.synchronize(self.device)
        self.instruments.ranges = False
        self.profile = Profile(prof, sum(c.video_seconds for c in clips),
                               list(self.instruments.calls))

    def check(self) -> tuple[dict, bool]:
        """Frees the program, then holds the sampled clips against the
        reference."""
        from perfbench import check, program, weights
        from perfbench.reference.clip import Reference

        picked = check.sample(self.records, self.cell.mix["check_clips"], self.seed)
        program.free(self.program)
        ref = Reference(weights.to_device(self.weights_host, self.device), self.serving,
                        self.cell.w2v)
        per_clip = [check.compare(r["served"], r["clip"], ref, self.serving) for r in picked]
        numbers = check.worst(per_clip)
        return numbers, check.verdict(numbers, self.cell.limits) and self.failed == 0


class Observation:
    """What the per-layer readers read: the window, its host spans, the
    profiled clips."""

    def __init__(self, run: Run, win: dict):
        from perfbench import work

        self.window = win
        self.records = run.records
        self.host = dict(run.instruments.host) if run.instruments else {}
        self.profile = run.profile
        done = [r for r in run.records if r["served"] is not None]
        hw = run.traffic.frames.shape[1:3]
        self.ops: dict = {}
        for r in done:
            c = r["clip"]
            for kind, n in work.clip_work(run.serving, hw, c.frames.shape[0], c.fps,
                                          len(c.wav), run.cell.w2v).items():
                self.ops[kind] = self.ops.get(kind, 0.0) + n
        self.timings = [r["served"].result.timings for r in done]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                breakdown, checks: dict) -> str:
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = load_cell(a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    set_caches(ROOT)
    device = torch.device("cuda", 0)
    out_dir = tempfile.mkdtemp(prefix="perfbench_", dir=os.environ.get("TMPDIR"))
    try:
        run = Run(cell, a.seed, device, out_dir)
        run.warm_up()
        torch.cuda.synchronize(device)
        if a.trace:
            from perfbench.spans import Instruments

            run.instruments = Instruments(run.program)
            run.instruments.install()
        setup_s = time.perf_counter() - t_start
        win = run.window(a.seconds)
        attempted = len(run.records)
        print(f"window: {attempted} clips in {win['seconds']!r} s; collector {win['gc']}",
              file=sys.stderr)
        device_info_ = device_info(device, cell.chips)
        breakdown = None
        if a.trace:
            run.traced_clips(cell.mix["trace_clips"])
            obs = Observation(run, win)
            metrics = {}
            for m, reader in cell.per_layer:
                value = reader.read(obs)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info_["busy_s"] = run.profile.busy_s
            device_info_["window_s"] = run.profile.window_s
            breakdown = run.profile.breakdown()
            run.instruments.remove()
        else:
            values = {"video_s_per_s": win["video_s"] / win["seconds"], "setup_s": setup_s}
            walls = win["walls"]
            if len(walls) >= 2:
                values["clip_latency_p95_s"] = statistics.quantiles(walls, n=20,
                                                                    method="inclusive")[18]
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end if m["name"] in values}
        numbers, correct = run.check()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules that no run may load are loaded: {found}", file=sys.stderr)
        return 3
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}
    for k, v in numbers.items():
        if k not in checks:
            print(f"reading {k}: {v!r} (not compared in this cell)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr)
    print(result_line(correct, attempted, run.failed, metrics, device_info_, breakdown, checks),
          flush=True)
    return 0
