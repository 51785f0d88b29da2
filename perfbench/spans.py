"""The benchmark's spans: host timers and profiler ranges put around calls
into each layer of the program, from the benchmark's own files (as the smoke
script patches its ``PATH_SITES``), in traced runs only; and the reading of
the profiler's events, kept in memory.

Sites (span name: where):

- ``runner.wire``: ``DetectStage.prepare_wire`` (letterbox and I420 on the
  runner's prefetch thread; host time);
- ``runner.unpack``: ``DetectStage.unpack``; ``runner.track``: each call of
  the clip's tracker (``Pipeline._new_tracker``'s); host time both;
- ``detect.dispatch``: ``DetectStage.dispatch_wire`` (upload, I420 rebuild,
  network, decode, top-64, NMS);
- ``visual.static``: ``VisualStage.run_static_from_frames``;
  ``visual.dynamic``: ``VisualStage.run_dynamic``;
- ``runner.save``: ``Pipeline.save_outputs``;
- ``k3#i`` and ``k4#i``: the i-th call of ``fused_chain`` and
  ``fused_ssh_heads`` at the models' call sites, with the call's work;
- ``clip``: each profiled clip, the benchmark's call of ``Pipeline.run``.

A device operation belongs to the span in which the host launched it: its
launch (the CUDA runtime call with the same correlation id) lies inside the
span, and it ran on another stream than the audio thread's.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

from perfbench import work

PREFIX = "perfbench:"
#: the runtime calls that start device work (names may carry a version suffix)
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


class Instruments:
    """Installs the spans on a ``program.Program`` and takes them out again."""

    def __init__(self, program):
        self.program = program
        #: host seconds by span name
        self.host: dict[str, float] = defaultdict(float)
        #: (kernel, bytes, {type: operations}) of each K3 / K4 call, by index
        self.calls: list[tuple] = []
        self.ranges = False
        self._undo: list = []

    @contextlib.contextmanager
    def span(self, name: str, timed: bool, ranged: bool = True):
        rng = None
        if self.ranges and ranged:
            from torch.profiler import record_function

            rng = record_function(PREFIX + name)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if timed:
                self.host[name] += time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)

    def wrap(self, obj, attr: str, name: str, timed: bool = False, ranged: bool = True) -> None:
        orig = getattr(obj, attr)
        had = attr in vars(obj)

        def wrapper(*args, **kwargs):
            with self.span(name, timed, ranged):
                return orig(*args, **kwargs)

        setattr(obj, attr, wrapper)
        self._undo.append((obj, attr, orig, had))

    def install(self) -> None:
        from avcer_tpu_torch.models import retinaface

        prog = self.program
        pipe = prog.pipe
        # the prefetch thread's: a host timer, no profiler range (the idle
        # gaps are named by the main thread's spans)
        self.wrap(prog.face, "prepare_wire", "runner.wire", timed=True, ranged=False)
        self.wrap(prog.face.inner, "unpack", "runner.unpack", timed=True)
        self.wrap(prog.face, "dispatch_wire", "detect.dispatch")
        self.wrap(pipe.visual, "run_static_from_frames", "visual.static")
        self.wrap(pipe.visual, "run_dynamic", "visual.dynamic")
        self.wrap(pipe, "save_outputs", "runner.save")
        new_tracker = pipe._new_tracker
        instruments = self

        class Tracker:
            def __init__(self, inner):
                self.inner = inner

            def __call__(self, boxes):
                with instruments.span("runner.track", True):
                    return self.inner(boxes)

        pipe._new_tracker = lambda: Tracker(new_tracker())
        self._undo.append((pipe, "_new_tracker", new_tracker, False))
        self._kernel(retinaface, "fused_chain", "k3")
        self._kernel(retinaface, "fused_ssh_heads", "k4")

    def _kernel(self, module, attr: str, name: str) -> None:
        orig = getattr(module, attr)

        def wrapper(x, *args, **kwargs):
            if not self.ranges:
                return orig(x, *args, **kwargs)
            with self.span(f"{name}#{len(self.calls)}", False):
                out = orig(x, *args, **kwargs)
            self.calls.append((name,) + call_work(name, x, args, kwargs, out))
            return out

        setattr(module, attr, wrapper)
        self._undo.append((module, attr, orig, True))

    def remove(self) -> None:
        for obj, attr, orig, had in reversed(self._undo):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo = []


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and hasattr(t, "numel"))


def call_work(name: str, x, args, kwargs, out) -> tuple:
    """(bytes, {type: operations}) of one K3 or K4 call, from its shapes."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    int8 = kwargs.get("act_s") is not None
    if name == "k3":
        blocks = args[1] if len(args) > 1 else kwargs["blocks"]
        return work.chain_work(tuple(x.shape), tuple(blocks), x.element_size(), int8,
                               _bytes(*outs))
    leaky = args[2] if len(args) > 2 else kwargs.get("leaky", 0.0)
    return work.ssh_work(tuple(x.shape), leaky, kwargs.get("fpn_lat") is not None,
                         kwargs.get("fpn_merge") is not None, _bytes(kwargs.get("up")), int8,
                         x.element_size(), _bytes(*outs))


class Profile:
    """What a profiled stretch of clips shows: device operations with their
    launching span, the spans, and the clips' video seconds."""

    def __init__(self, prof, video_s: float, calls: list):
        from torch.autograd import DeviceType

        self.video_s = video_s
        self.calls = calls
        runtime: dict[int, int] = {}
        device: list = []
        ranges: list = []
        events = prof.profiler.kineto_results.events()
        base = min((e.start_ns() for e in events), default=0)

        def span_of(e) -> tuple:
            return (e.start_ns() - base) * 1e-9, (e.start_ns() - base + e.duration_ns()) * 1e-9

        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith(PREFIX) or e.is_user_annotation():
                    continue  # a host range's shadow on the device's timeline
                device.append(span_of(e) + (name, e.device_resource_id(), e.correlation_id()))
            elif name.startswith(PREFIX):
                ranges.append(span_of(e) + (name[len(PREFIX):],))
            elif name.startswith(LAUNCHES):
                runtime[e.correlation_id()] = span_of(e)[0]
        if not device:
            raise RuntimeError("the profiler's events hold no device operation")
        marker = [r for r in ranges if r[2] == "audio_stream"]
        launched = {}
        for d in device:
            t = runtime.get(d[4])
            launched[id(d)] = t
        audio = {d[3] for d in device if marker and launched[id(d)] is not None
                 and marker[0][0] <= launched[id(d)] <= marker[0][1]}
        self.device = device
        self.ranges = sorted(r for r in ranges if r[2] != "audio_stream")
        clips = [r for r in self.ranges if r[2] == "clip"]
        self.start, self.stop = clips[0][0], clips[-1][1]
        self.window_s = self.stop - self.start
        inside = [(max(s, self.start), min(e, self.stop)) for s, e, *_ in device
                  if e > self.start and s < self.stop]
        self.busy_s = work.busy_union(inside)
        self.gaps = work.idle_gaps(inside, self.start, self.stop)
        #: launch times and device seconds of the main streams' operations
        main = sorted((launched[id(d)], d[1] - d[0]) for d in device
                      if launched[id(d)] is not None and d[3] not in audio)
        self._launch = [t for t, _ in main]
        self._cum = [0.0]
        for _, dur in main:
            self._cum.append(self._cum[-1] + dur)
        self._starts = [r[0] for r in self.ranges]

        self._named: dict[str, list] = defaultdict(list)
        for s, e, name in self.ranges:
            self._named[name].append((s, e))

    def device_within(self, name: str, prefix: bool = False) -> float:
        """Device seconds of the operations launched inside any span called
        ``name`` (or, with ``prefix``, whose name starts with it); nested
        spans' operations included."""
        total = 0.0
        names = [k for k in self._named if k.startswith(name)] if prefix else [name]
        for k in names:
            for s, e in self._named.get(k, ()):
                i = bisect.bisect_left(self._launch, s)
                j = bisect.bisect_right(self._launch, e)
                total += self._cum[j] - self._cum[i]
        return total

    def innermost(self, t: float, skip_clip: bool = False):
        """The innermost span open at ``t`` (spans nest a few deep: the last
        one to start that is still open)."""
        i = bisect.bisect_right(self._starts, t) - 1
        for s, e, name in self.ranges[max(0, i - 256):i + 1][::-1]:
            if s <= t <= e and not (skip_clip and name == "clip"):
                return name
        return None

    def breakdown(self) -> dict:
        ops: dict[str, float] = defaultdict(float)
        for s, e, name, *_ in self.device:
            if e > self.start and s < self.stop:
                ops[name[:100]] += e - s
        idle: dict[str, float] = defaultdict(float)
        for a, b in self.gaps:
            name = self.innermost((a + b) / 2) or "outside the clips"
            idle["host in " + name.split("#")[0]] += b - a
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}

    def kernel_calls(self, kernel: str) -> list:
        """(bound seconds, device seconds) of each call of ``kernel``."""
        out = []
        for i, (name, nbytes, ops) in enumerate(self.calls):
            if name == kernel:
                out.append((work.bound_s(nbytes, ops), self.device_within(f"{kernel}#{i}")))
        return out
