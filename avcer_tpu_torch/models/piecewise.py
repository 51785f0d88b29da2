"""Piecewise CUDA graphs: the stretches of small launches between a
function's kernel calls captured once and replayed, the kernel calls made
eagerly between them on every run.

A function marks each kernel call site with ``call(resolve, args, kwargs)``:
``resolve()`` is the kernel's wrapper, looked up at every call (a caller may
have wrapped it since), and is called with ``args`` and ``kwargs``. Outside
a capture that is all it does. The wrapper must take ``out=``: tensors like
its results (the same structure) to write them into.

``Schedule(fn, x, stream)`` runs ``fn(x)`` once as a capture, on ``stream``:
each stretch between two marked calls (a *piece*) is captured as one CUDA
graph and replayed at once, so that the call after it sees real values; the
marked calls run eagerly and are kept with their arguments and results.
``replay_head(x)`` and ``replay_tail()`` then copy ``x`` into the captured
input and run the graphs and the kept calls in their order on the current
stream, without running ``fn``'s Python: each kept call writes into the
results it gave at the capture (``out=``), where the graphs after it read
them. A piece that captured nothing (two kernel calls back to back) is left
out.

What a piece makes lives in the graphs' memory pool and is rewritten by
every replay; the result is copied out of it. Each replay counts again the
kernel launches its graphs counted while captured (``utils.trace.launched``).
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Any, Callable

import torch

from avcer_tpu_torch.utils import trace

_local = threading.local()


def call(resolve: Callable[[], Callable], args: tuple, kwargs: dict) -> Any:
    """A kernel call site: ``resolve()(*args, **kwargs)``. While this thread
    captures (``Schedule``) the call ends the piece before it and starts the
    next."""
    capture = getattr(_local, "capture", None)
    if capture is None:
        return resolve()(*args, **kwargs)
    return capture.eager_call(resolve, args, kwargs)


class _Call:
    """A kept kernel call: its wrapper, its arguments and the results of the
    capture run, which the graphs after it read."""

    __slots__ = ("resolve", "args", "kwargs", "out")

    def __init__(self, resolve, args, kwargs, out):
        self.resolve, self.args, self.kwargs, self.out = resolve, args, kwargs, out

    def __call__(self):
        return self.resolve()(*self.args, **self.kwargs, out=self.out)


class Schedule:
    """The pieces of ``fn`` captured on an input like ``x`` (see the module's
    doc); ``steps``: the graphs (each with its launch log) and the kept
    calls, in order. Raises where the capture fails (an operation that
    synchronises, say), the stream no longer capturing."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                 stream: torch.cuda.Stream):
        self.steps: list = []
        self.pool = torch.cuda.graph_pool_handle()
        self._graph = None
        self._log: list = []
        current = torch.cuda.current_stream(x.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            try:
                self.x = x.clone()
                _local.capture = self
                self._begin()
                out = fn(self.x)
                self._end()
            finally:
                _local.capture = None
                trace.note_launches(None)
                if self._graph is not None:  # failed inside a piece: end its capture
                    graph, self._graph = self._graph, None
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
        current.wait_stream(stream)
        self.out = out
        #: the capture run's result, copied out of the pool
        self.first = out.clone()
        #: the steps up to the last kept call (all where ``fn`` makes none)
        self._head = max((i + 1 for i, s in enumerate(self.steps) if isinstance(s, _Call)),
                         default=len(self.steps))

    def _begin(self) -> None:
        self._log = []
        trace.note_launches(self._log)
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def _end(self) -> None:
        trace.note_launches(None)
        graph, self._graph = self._graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        if any("empty" in str(w.message) for w in caught) and not self._log:
            return  # nothing captured
        graph.replay()
        self.steps.append((graph, self._log))

    def eager_call(self, resolve, args, kwargs):
        self._end()
        out = resolve()(*args, **kwargs)
        self.steps.append(_Call(resolve, args, kwargs, out))
        self._begin()
        return out

    def _run(self, steps) -> None:
        for step in steps:
            if isinstance(step, _Call):
                step()
            else:
                graph, log = step
                graph.replay()
                trace.relaunched(log)

    def replay_head(self, x: torch.Tensor) -> None:
        """The input copied in, then the steps up to the last kernel call."""
        self.x.copy_(x)
        self._run(self.steps[:self._head])

    def replay_tail(self) -> torch.Tensor:
        """The steps after the last kernel call; the result, copied."""
        self._run(self.steps[self._head:])
        return self.out.clone()


class Graphs:
    """The schedules of one function by key. A key's first run on each
    thread is eager (the warm-up: folds, plans, constants and the thread's
    own library handles, which a capture cannot create, settle there); a
    thread's next run outside a profiler's recording captures; later runs,
    on any thread, replay. A key whose capture raised stays eager. ``lock``:
    held around a warm-up (so that no capture starts before it ends), a
    capture or a replay, whose buffers are shared."""

    def __init__(self):
        self.lock = threading.Lock()
        #: a key's schedule, or "failed"
        self._state: dict = {}
        #: the threads that ran each key's warm-up
        self._warmed: dict = {}
        self._stream = None
        #: (schedule, event after its last replay) of dropped schedules, kept
        #: until the card has finished with them
        self._retired: list = []

    def route(self, key) -> tuple[str, Any]:
        """("replay", schedule), ("capture", None), ("warm-up", None) or
        ("eager", None) for ``key``; call under ``lock``."""
        state = self._state.get(key)
        if isinstance(state, Schedule):
            return "replay", state
        if state == "failed":
            return "eager", None
        warmed = self._warmed.setdefault(key, set())
        if threading.get_ident() not in warmed:
            warmed.add(threading.get_ident())
            return "warm-up", None
        if trace.profiling():
            return "eager", None
        return "capture", None

    def capture(self, key, fn, x: torch.Tensor) -> Schedule:
        """Capture ``fn`` on ``x`` for ``key``; where that raises, the key is
        marked failed and the error raised. Call under ``lock``."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(x.device)
        try:
            sched = Schedule(fn, x, self._stream)
        except Exception:
            self._state[key] = "failed"
            self._stream = None  # a stream of its own for the next capture
            raise
        self._state[key] = sched
        return sched

    def clear(self) -> None:
        """Drop every schedule (their graphs read tensors that changed); the
        next run of a key is its warm-up again. Call under ``lock``."""
        self._retired = [(s, e) for s, e in self._retired if not e.query()]
        for state in self._state.values():
            if isinstance(state, Schedule):
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(state.x.device))
                self._retired.append((state, event))
        self._state.clear()
        self._warmed.clear()
