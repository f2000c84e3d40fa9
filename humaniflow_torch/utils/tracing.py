"""Spans and counters of the port's layers: one record, on the host clock
and, under torch.profiler, on the device trace's clock.

    from humaniflow_torch.utils import tracing

    with tracing.tracing():
        pred = predict_humaniflow(...)
    tracing.summary()  # {"predict": {"calls": 1, "host_s": ..., "self_s": ..., "counters": {...}}, ...}

`span(name)` marks a layer of the program (the names are dotted, as
"hrnet.upload"); `count(name, n)` adds n to a counter of the innermost open
span of the calling thread ("h2d_bytes"; "graph_captures" and
"graph_replays" on `dist_infer`, pipelines/predict.py's CUDA graph).  Each
span also takes the launches of the hand-written kernels inside it, from the
`LAUNCHES` dicts of their wrappers (models/cuda_lbs.py,
render/cuda_raster.py, ...), which register themselves here through
`launch_counter`.  K5's and K2's wrappers count no launch recorded into a
CUDA graph's capture, and a replay launches from no wrapper: the device
trace sees a replay's kernels.

Tracing is off by default.  Off, `span` returns one shared object that
does nothing, after a check of this module's flag and of torch's flag of a
running profiler.  Under a torch.profiler session it returns a range of
the span's name and records nothing, so that every profiler trace names
the program's layers among its host events.  The range is a host operation
as an aten operator is one (torch's `_RecordFunctionFast`), not a
`record_function` annotation: the profiler draws an annotation again on
the device's timeline, as a range from its first kernel to its last, which
a reader of the trace would take for a kernel.  Inside `tracing()` it
records the span's name, its start and end (`time.perf_counter_ns`), its
parent, the call id shared by every span under one root span and its
counters, and under a profiler enters the range too.  A span never synchronises a device and
never reads a tensor, so a span's host time is the time the host spent in
the layer: where the device is behind, a synchronise inside the layer (a
`.cpu()`, a `bool` of a tensor) holds that wait.  The stack of open spans
is per thread.

`records()` gives the last RING span instances (a ring: a long run keeps
the newest); `summary()` the per-name totals of every span since the last
`reset()`, which are not bounded by the ring.
"""

import contextlib
import functools
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler

RING = 65_536

_ON = False
_LAUNCHES: List[Dict[str, int]] = []  # the kernel wrappers' LAUNCHES dicts
_local = threading.local()
_lock = threading.Lock()
_ids = itertools.count(1)
_calls = itertools.count(1)
_records: deque = deque(maxlen=RING)
_totals: Dict[str, list] = {}  # name -> [calls, host ns, self ns, counters]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _profiling() -> bool:
    """Whether a torch.profiler session runs (torch's private flag, looked
    up at each call so that a torch without it only loses the ranges)."""
    return getattr(_profiler, "_is_profiler_enabled", False)


def _range(name: str):
    """A host range `name` of the profiler's trace, not an annotation
    (torch's private `_RecordFunctionFast`, looked up on use; a torch
    without it gets no range)."""
    fast = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)
    return _NO_SPAN if fast is None else fast(name)


def launch_counter(counts: Dict[str, int]) -> Dict[str, int]:
    """Register a kernel wrapper's dict of launch counts (kernel name →
    launches so far), which spans then read at open and close; returns it."""
    _LAUNCHES.append(counts)
    return counts


def _launch_totals() -> Dict[str, int]:
    return {k: v for counts in _LAUNCHES for k, v in counts.items()}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded span instance: id, name, parent (the parent's id, or
    None for a root), call (the id shared under one root), start_ns and
    end_ns (`time.perf_counter_ns`), child_ns (the time its children
    cover) and counters (name → total inside it, the kernels' launches
    under their `LAUNCHES` names)."""

    __slots__ = ("id", "name", "parent", "call", "start_ns", "end_ns", "child_ns", "counters", "_launches", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, next(_calls)
        self.child_ns, self.counters = 0, {}
        self._range = None
        if _profiling():
            self._range = _range(self.name)
            self._range.__enter__()
        self._launches = _launch_totals()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        for k, v in _launch_totals().items():
            n = v - self._launches.get(k, 0)
            if n:
                self.counters[k] = self.counters.get(k, 0) + n
        stack = _stack()
        stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._range = self._launches = None
        ns = self.end_ns - self.start_ns
        if stack:
            stack[-1].child_ns += ns
        with _lock:
            _records.append(self)
            tot = _totals.setdefault(self.name, [0, 0, 0, {}])
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - self.child_ns
            for k, n in self.counters.items():
                tot[3][k] = tot[3].get(k, 0) + n
        return False

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_s(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e9


def span(name: str):
    """A context manager around a layer of the program (see the module's
    docstring): a recorded Span inside `tracing()`, a host range of the
    profiler's trace under a profiler, else a shared object that does
    nothing."""
    if _ON:
        return Span(name)
    if _profiling():
        return _range(name)
    return _NO_SPAN


def count(name: str, n) -> None:
    """Add n to counter `name` of the calling thread's innermost open span
    (nothing when tracing is off or no span is open)."""
    if not _ON:
        return
    stack = _stack()
    if stack:
        counters = stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def enabled() -> bool:
    """Whether spans record (inside `tracing()`): for a caller whose count
    costs more than a flag check to compute."""
    return _ON


@contextlib.contextmanager
def tracing():
    """Record spans within the block (in every thread)."""
    global _ON
    before, _ON = _ON, True
    try:
        yield
    finally:
        _ON = before


def records() -> List[Span]:
    """The last RING closed span instances, oldest first."""
    with _lock:
        return list(_records)


def summary() -> Dict[str, dict]:
    """Per span name, over every instance since the last reset: calls,
    host_s, self_s (host_s less the part its children cover) and counters
    (their totals)."""
    with _lock:
        return {name: {"calls": n, "host_s": host / 1e9, "self_s": own / 1e9, "counters": dict(counters)}
                for name, (n, host, own, counters) in _totals.items()}


def reset() -> None:
    """Forget every recorded instance and total."""
    with _lock:
        _records.clear()
        _totals.clear()


@contextlib.contextmanager
def traced_to(path):
    """Record spans within the block, from a reset, and write `summary()`
    to `path` as JSON when it ends (the CLIs' --trace_spans); with path
    None, nothing."""
    if path is None:
        yield
        return
    reset()
    try:
        with tracing():
            yield
    finally:
        with open(path, "w") as f:
            json.dump(summary(), f, indent=1, sort_keys=True)


def traced(name: str):
    """Decorator: every call of the function is a span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap
