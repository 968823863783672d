# Port of vgan_tpu/utils/profiling.py (the PROFILER part), extended: stages are spans with parents on the device trace's clock, with counters beside them; jax_trace becomes torch_trace.
"""Spans, counters and stage timing of the port's host code.

The reference has no tracing (SURVEY.md §5 — only progress bars). One
tracer, PROFILER, records what the host does at the layers' boundaries:

* `span(name)` times a block: (id, parent id, thread id, name, start
  ns, end ns) on `time.time_ns()`, the epoch clock that torch.profiler's
  trace stamps the card's events with, so a span and the kernels it
  queued line up. The parent is the thread's innermost open span. A span
  never synchronizes: it measures the host, and the card's side comes
  from the trace on the same clock.
* `count(name, n)` adds to a named counter.
* `stage(name, items)` is a span that also counts the items it handled;
  `stages` and `report()` sum the spans by name, and `report()` prints
  the counters after them.

Recording is on while `enabled` is set (the CLI's `--profile`, or
`enable()`) or while a torch.profiler session runs; then each span also
opens a `record_function` of its name, so torch_trace's files show the
spans beside the kernels. Off, a span or a count costs one flag test: no
clock read, no allocation.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, NamedTuple

from torch.autograd import profiler as _autograd_profiler


class Span(NamedTuple):
    id: int
    parent: int  # 0 for a span opened outside any other on its thread
    tid: int
    name: str
    start_ns: int
    end_ns: int
    items: int = 0


@dataclass
class StageStats:
    name: str
    seconds: float = 0.0
    items: int = 0
    calls: int = 0

    @property
    def per_s(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


_OFF = contextlib.nullcontext()


class _Open:
    """One span while it is open (recording on)."""

    __slots__ = ("prof", "name", "items", "id", "parent", "stack", "t0",
                 "rf")

    def __init__(self, prof: "Profiler", name: str, items: int):
        self.prof, self.name, self.items = prof, name, items

    def __enter__(self):
        stack = self.prof._stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(self.prof._ids)
        stack.append(self.id)
        self.stack = stack
        self.rf = None
        self.t0 = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.time_ns()
        self.stack.pop()
        self.prof._spans.append(Span(self.id, self.parent,
                                     threading.get_ident(), self.name,
                                     self.t0, t1, self.items))
        return False


class Profiler:
    """Spans and counters, kept in memory until `clear()`. Spans of any
    thread append to one list; each thread keeps its own stack of open
    spans."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counters: Dict[str, int] = {}
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str, items: int = 0):
        """A context manager that records the block as a span (a shared
        no-op while recording is off)."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Open(self, name, items)

    def stage(self, name: str, items: int = 0):
        """A span that handled `items` items (reads, rows)."""
        return self.span(name, items)

    def traced(self, name: str):
        """Decorator: each call of the function is a span."""
        def wrap(fn):
            @functools.wraps(fn)
            def call(*args, **kw):
                with self.span(name):
                    return fn(*args, **kw)
            return call
        return wrap

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled or _autograd_profiler._is_profiler_enabled:
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def recording(self):
        """Recording on for the block, whatever `enabled` was."""
        was, self.enabled = self.enabled, True
        try:
            yield self
        finally:
            self.enabled = was

    def _stack(self) -> List[int]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def records(self) -> List[Span]:
        """The closed spans, in the order they closed."""
        return list(self._spans)

    def clear(self) -> None:
        """Drop the spans and the counters."""
        self._spans.clear()
        with self._lock:
            self.counters.clear()

    @property
    def stages(self) -> Dict[str, StageStats]:
        """`stage_stats` of every recorded span."""
        return stage_stats(self._spans)

    def report(self, file=sys.stderr) -> None:
        """Each span name's total and self time, indented under its
        parent's, as shares of the time the root spans cover; then the
        counters."""
        spans = self.records()
        if spans:
            self._report_spans(spans, file)
        if self.counters:
            print("── counters ──", file=file)
            for name in sorted(self.counters):
                print(f"  {name:<32} {self.counters[name]:>16,}", file=file)

    @staticmethod
    def _report_spans(spans: List[Span], file) -> None:
        by_id = {s.id: s for s in spans}
        own = self_times(spans)
        path_of: Dict[int, tuple] = {}

        def path(s: Span) -> tuple:
            if s.id not in path_of:
                p = by_id.get(s.parent)
                path_of[s.id] = (path(p) if p else ()) + (s.name,)
            return path_of[s.id]

        rows: Dict[tuple, list] = {}
        first: Dict[tuple, int] = {}
        for s in sorted(spans, key=lambda s: s.start_ns):
            key = path(s)
            r = rows.setdefault(key, [0, 0, 0])
            r[0] += s.end_ns - s.start_ns
            r[1] += own[s.id]
            r[2] += s.items
            first.setdefault(key, s.start_ns)
        total = union_ns((s.start_ns, s.end_ns) for s in spans
                         if s.parent not in by_id)
        if total <= 0:
            return
        order = sorted(rows, key=lambda k: tuple(first[k[:i + 1]]
                                                for i in range(len(k))))
        print("── stage timing (total, self) ──", file=file)
        for key in order:
            tot, slf, items = rows[key]
            name = "  " * (len(key) - 1) + key[-1]
            rate = f"  {items / (tot / 1e9):,.0f}/s" if items and tot else ""
            print(f"  {name:<32} {tot / 1e9:8.2f}s ({100 * tot / total:5.1f}%)"
                  f"  self {slf / 1e9:8.2f}s ({100 * slf / total:5.1f}%)"
                  f"{rate}", file=file)
        print(f"  {'total':<32} {total / 1e9:8.2f}s", file=file)


def stage_stats(spans: Iterable[Span]) -> Dict[str, StageStats]:
    """Seconds, items and calls of `spans` by name, in the order each
    name first closed."""
    out: Dict[str, StageStats] = {}
    for s in spans:
        st = out.setdefault(s.name, StageStats(s.name))
        st.seconds += (s.end_ns - s.start_ns) / 1e9
        st.items += s.items
        st.calls += 1
    return out


def self_times(spans: Iterable[Span]) -> Dict[int, int]:
    """{span id: its duration less what its children cover, ns}. A
    thread's children of one span never overlap, so their durations
    add up to the part they cover."""
    spans = list(spans)
    covered: Dict[int, int] = {}
    for s in spans:
        if s.parent:
            covered[s.parent] = covered.get(s.parent, 0) + s.end_ns \
                - s.start_ns
    return {s.id: s.end_ns - s.start_ns - covered.get(s.id, 0)
            for s in spans}


def union_ns(intervals: Iterable[tuple]) -> int:
    """Length of the union of [start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


PROFILER = Profiler(enabled=False)


def enable() -> Profiler:
    PROFILER.enabled = True
    return PROFILER


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Capture a torch.profiler trace of the block: CPU activity, and
    the card's (CUDA) when one is visible, with PROFILER's spans as
    `record_function` ranges. On exit the trace is written into `logdir`
    as a Chrome trace (`torch_trace.<pid>.json`, one file a process;
    open it in chrome://tracing or Perfetto). Yields the profiler, whose
    key_averages() sum the time by operator and kernel. The counterpart
    of the JAX package's jax_trace."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"torch_trace.{os.getpid()}.json"))
