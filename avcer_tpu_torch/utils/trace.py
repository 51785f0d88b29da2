"""Spans and counters inside the port, on the profiler's clock.

Recording is on exactly while a ``torch.profiler`` records in the process
(``cli.run --profile_dir``, or any caller's profiler); there is no switch of
its own. Off, ``span`` returns one shared no-op context manager after one
check of ``torch.autograd.profiler._is_profiler_enabled`` (the process-wide
flag: the profiler's C state is per thread, and the runner's prefetch and
audio threads record too). On, a span keeps in memory its name, its start and
end in ``time.time_ns()`` (the profiler's own clock: its events' stamps are
Unix nanoseconds), its parent on the same thread, its thread, the id of the
clip (``Pipeline.run``) it serves and a few attributes, and enters
``record_function("avcer:" + name)`` so that the range lands in the
profiler's trace as well. Spans of set-up (``setup``: kernel libraries,
folds, packs, occupancy queries, ``build_pipeline``) are recorded whether or
not a profiler records; they run a few times a process.

``clip`` opens a clip's record: its counters (``count``; among them
``detect.frames``, ``detect.upload_bytes``, and ``detect.graph_replays``,
``detect.graph_captures`` and ``detect.graph_eager``: the detect batches
that replayed their piecewise graphs, captured them, or ran eagerly) and
the launches of the kernel wrappers over the clip (the difference of their
``.launches`` attributes, which ``launched`` counts, a replayed graph's
launches included; clips served at once by ``Pipeline.run_many`` see each
other's).
The runner hands the clip to its worker threads in a copied
``contextvars`` context.

``idle_self`` joins spans with the card's busy intervals on one clock: the
card's idle seconds in each span's self time. ``report`` is what ``cli.run
--profile_dir`` writes as ``spans.json``.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Optional, Sequence

import torch.autograd.profiler as _profiler

#: the prefix of a span's range in the profiler's trace
PREFIX = "avcer:"
SETUP = "setup."
#: spans of set-up kept while no profiler records, at most
MAX_SETUP = 4096

_ids = itertools.count(1)
_local = threading.local()
_clip: contextvars.ContextVar[Optional["Clip"]] = contextvars.ContextVar("avcer_clip",
                                                                          default=None)
_lock = threading.Lock()
_spans: list["Span"] = []
_clips: list["Clip"] = []
_threads: dict[int, str] = {}
_unprofiled = 0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _threads[threading.get_ident()] = threading.current_thread().name
    return stack


class _Null:
    """The span while nothing records: enters, exits, notes nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def __bool__(self):
        return False

    def note(self, **attrs) -> None:
        pass


NULL = _Null()


class Span:
    """One recorded span. ``start`` and ``end`` are ``time.time_ns()``;
    ``parent`` is the id of the innermost span open on the same thread when
    it began (None at a thread's top level); ``clip`` the id of its clip."""

    __slots__ = ("id", "name", "start", "end", "parent", "thread", "clip", "attrs", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.start = self.end = 0
        self.parent = self.clip = None
        self.thread = 0
        self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def note(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        clip = _clip.get()
        self.clip = None if clip is None else clip.id
        stack.append(self)
        self.start = time.time_ns()
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.end = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        _spans.append(self)
        return False

    def __repr__(self):
        return f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, clip={self.clip})"


def profiling() -> bool:
    """Whether a profiler records in this process."""
    return bool(_profiler._is_profiler_enabled)


def span(name: str, **attrs):
    """A span named ``name`` around the body while a profiler records, else
    ``NULL`` (falsy: ``if sp: sp.note(...)`` computes attributes only when
    recording)."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return Span(name, attrs)


def setup(name: str, **attrs):
    """The span ``setup.<name>``, recorded with or without a profiler (up to
    ``MAX_SETUP`` of them without one)."""
    global _unprofiled
    if not _profiler._is_profiler_enabled:
        with _lock:
            if _unprofiled >= MAX_SETUP:
                return NULL
            _unprofiled += 1
    return Span(SETUP + name, attrs)


def annotate(name: str, **attrs) -> None:
    """Add ``attrs`` to the innermost open span of this thread if it is
    called ``name`` (a kernel wrapper's plan, known inside the launch)."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack and stack[-1].name == name:
        stack[-1].attrs.update(attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current clip's counter ``name`` while recording."""
    if not _profiler._is_profiler_enabled:
        return
    clip = _clip.get()
    if clip is not None:
        with _lock:
            clip.counts[name] = clip.counts.get(name, 0) + n


def _launch(fn, by: dict) -> None:
    with _lock:
        fn.launches += 1
        for attr, key in by.items():
            counts = getattr(fn, attr)
            counts[key] = counts.get(key, 0) + 1


def launched(fn, **by) -> None:
    """Count one launch of the kernel wrapper ``fn``: ``fn.launches`` and,
    for each ``attr=key``, the entry ``key`` of the dict ``fn.<attr>``.
    While this thread captures a graph (``models.piecewise``) the launch is
    also noted, to be counted again at each replay of that graph."""
    _launch(fn, by)
    log = getattr(_local, "launch_log", None)
    if log is not None:
        log.append((fn, by))


def note_launches(log: Optional[list]) -> None:
    """Append this thread's launches (``launched``) to ``log`` from now on;
    None stops."""
    _local.launch_log = log


def relaunched(log: Sequence[tuple]) -> None:
    """Count again the launches ``note_launches`` noted: a replayed graph's."""
    for fn, by in log:
        _launch(fn, by)


def launches() -> dict[str, int]:
    """The kernel wrappers' launch counters: K3, K4, K1, K2, the I420
    rebuild."""
    from avcer_tpu_torch.ops.cuda import (attention_kernel, fused_resnet_kernel,
                                          fused_ssh_kernel, image_kernel, nms_kernel)

    return {"fused_chain": fused_resnet_kernel.fused_chain.launches,
            "fused_ssh_heads": fused_ssh_kernel.fused_ssh_heads.launches,
            "nms_mask": nms_kernel.nms_mask.launches,
            "mha": attention_kernel.mha.launches,
            "i420_to_bgr": image_kernel.i420_to_bgr.launches}


class Clip:
    """One clip's record: its ``clip`` span's id, thread and stamps, the
    counters and the launch differences."""

    def __init__(self):
        self.attrs: dict = {}
        self._span = Span("clip", self.attrs)
        self.id = self._span.id
        self.counts: dict[str, int] = {}
        self.launches: dict[str, int] = {}
        self.thread = threading.get_ident()
        self.start = self.end = 0
        self._token = None
        self._launches0: dict[str, int] = {}

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def __enter__(self):
        # the stamps as near the call's own start and end as can be: they
        # anchor the clip against other records of the same call
        self._token = _clip.set(self)
        self._span.__enter__()
        self.start = self._span.start
        self._launches0 = launches()
        return self

    def __exit__(self, *exc):
        after = launches()
        self._span.__exit__(*exc)
        self.end = self._span.end
        _clip.reset(self._token)
        self.launches = {k: after[k] - v for k, v in self._launches0.items()}
        _clips.append(self)
        return False


def clip():
    """The record of one ``Pipeline.run`` while recording (its span is
    ``clip``, its id the span's), else ``NULL``."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return Clip()


def spans() -> list[Span]:
    """Every finished span, in the order they ended."""
    return list(_spans)


def clips() -> list[Clip]:
    """Every finished clip record, in the order they ended."""
    return list(_clips)


def idle_self(spans: Sequence[tuple[float, float]], busy: Sequence[tuple[float, float]],
              start: float, stop: float) -> tuple[list[float], float]:
    """The join of one thread's spans with the card's busy intervals, all on
    one clock: of the time in ``[start, stop]`` in which no busy interval
    runs, what lies in each span's self time (inside it and inside none of
    the spans it encloses), and what lies in no span. ``spans`` are (start,
    end) pairs that nest as one thread's context managers nest. Returns
    (idle of each span, in the order given; idle outside every span)."""
    gaps = []
    t = start
    for s, e in sorted(busy):
        if e <= t:
            continue
        if s >= stop:
            break
        if s > t:
            gaps.append((t, s))
        t = e
        if t >= stop:
            break
    if t < stop:
        gaps.append((t, stop))
    # the spans' self segments: (from, to, owner), owner -1 in no span
    segments = []
    stack: list[int] = []
    t = -float("inf")

    def close_until(until: float) -> None:
        nonlocal t
        while stack and spans[stack[-1]][1] <= until:
            j = stack.pop()
            end = spans[j][1]
            if end > t:
                segments.append((t, end, j))
                t = end

    for i in sorted(range(len(spans)), key=lambda k: (spans[k][0], -spans[k][1])):
        s, e = spans[i]
        close_until(s)
        if s > t:
            segments.append((t, s, stack[-1] if stack else -1))
            t = s
        stack.append(i)
    close_until(float("inf"))
    segments.append((t, float("inf"), -1))
    idle = [0.0] * len(spans)
    outside = 0.0
    k = 0
    for a, b in gaps:
        while k < len(segments) and segments[k][1] <= a:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < b:
            lo, hi, owner = segments[j]
            overlap = min(b, hi) - max(a, lo)
            if overlap > 0:
                if owner < 0:
                    outside += overlap
                else:
                    idle[owner] += overlap
            j += 1
    return idle, outside


def device_intervals(prof) -> list[tuple[int, int]]:
    """(start, end) in Unix nanoseconds of every kernel, copy and set a
    ``torch.profiler`` recorded on a CUDA device (host ranges' shadows on the
    device's timeline left out)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        if e.name().startswith(PREFIX):
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns()))
    return out


def report(device: Sequence[tuple[int, int]], since: int = 0) -> dict:
    """What ``spans.json`` holds: the clips recorded since ``since``
    (``time.time_ns()``), each with its spans by name (count, total and self
    seconds, and for the serving thread's spans the card's idle seconds in
    their self time, ``idle_self`` against ``device``), its counters and
    launch differences; and the set-up spans of the process by name."""
    all_spans = spans()
    out = {"clock": "time.time_ns (Unix ns, the profiler's clock)",
           "device_intervals": len(device), "clips": [], "setup": {}}
    for c in clips():
        if c.start < since:
            continue
        own = [s for s in all_spans if s.clip == c.id]
        child_s: dict[int, float] = {}
        for s in own:
            if s.parent is not None:
                child_s[s.parent] = child_s.get(s.parent, 0.0) + s.seconds
        serving = [s for s in own if s.thread == c.thread]
        busy = [(a, b) for a, b in device if b > c.start and a < c.end]
        idle, outside = idle_self([(s.start, s.end) for s in serving], busy, c.start, c.end)
        idle_s = (sum(idle) + outside) * 1e-9
        idle_of = {s.id: v * 1e-9 for s, v in zip(serving, idle)}
        by_name: dict[str, dict] = {}
        for s in sorted(own, key=lambda s: s.start):
            row = by_name.setdefault(s.name, {
                "thread": "serving" if s.thread == c.thread else _threads.get(s.thread, "?"),
                "n": 0, "total_s": 0.0, "self_s": 0.0,
                "idle_s": 0.0 if s.thread == c.thread else None})
            row["n"] += 1
            row["total_s"] += s.seconds
            row["self_s"] += s.seconds - child_s.get(s.id, 0.0)
            if row["idle_s"] is not None:
                row["idle_s"] += idle_of.get(s.id, 0.0)
        out["clips"].append({"id": c.id, **c.attrs, "wall_s": c.seconds,
                             "busy_s": c.seconds - idle_s, "idle_s": idle_s, "spans": by_name,
                             "counts": dict(c.counts), "launches": dict(c.launches)})
    for s in all_spans:
        if s.name.startswith(SETUP):
            row = out["setup"].setdefault(s.name, {"n": 0, "s": 0.0})
            row["n"] += 1
            row["s"] += s.seconds
    return out
