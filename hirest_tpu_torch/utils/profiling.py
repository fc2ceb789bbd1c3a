"""Tracing / profiling / metrics observability.

Counterpart of hirest_tpu/utils/profiling.py: `PhaseTimer` and
`MetricsLogger` are copies; `trace` runs torch.profiler in place of
jax.profiler. The reference has none of this (SURVEY §5.1: tqdm bars and
prints only; a wandb flag that never logs, run.py:30,205-207). Here:

- span(): the program's own spans, on the profiler's clock (below);
- PhaseTimer: accumulates wall-clock per named phase (data, train_step,
  eval, ...) for per-epoch reports, each phase also a span `train.<name>`;
- trace(): context manager around torch.profiler for on-demand device
  traces (a Chrome trace, viewable in Perfetto);
- MetricsLogger: append-only JSONL sink for scalar metrics (step, loss,
  lr, throughput) — greppable, plottable, no external service.

Spans. `with span(name, **attrs) as s:` marks one stretch of the host's
work. Where no torch.profiler session records the thread, it is one
shared null context (`s` is None): no clock read, no record. Under a
profiler (`trace()`'s, or any other `torch.profiler.profile`), it opens
`record_function("hirest." + name)`, so the range lies in the Chrome
trace beside the device's kernels, and appends a `SpanRecord` to a
bounded buffer (`spans()`, `clear_spans()`): its name, start and end in
`time.time_ns()` read just inside the range (the clock the profiler's
events are on, Unix nanoseconds), the thread, its id, its parent (the
innermost span open on the thread), the trace id it shares with its
parent (a span without one starts a trace), and `attrs`: counters read
where the work happens, such as bytes copied, which the block may add to
`s.attrs`. The torch.profiler session records the thread that started
it, not threads started in Python; a thread that works for a span
carries it over with `adopt(current())`, and its spans then record into
the buffer as children of that span, with no range in the Chrome trace.

The extraction path's spans: `prefetch.start`, `prefetch.wait` and, on
the prefetch thread (so in `spans()` alone), `prefetch.produce`
(data/prefetch.py); `eva.copy_in` (attr `bytes`) and `eva.forward`
(models/eva_scan.py's apply); `features.fetch` and `features.normalise`
(extraction/features.py::finish_video_features); and around each video
of `extract_video_features` `extract.video` (`video`) with its
`extract.save`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple, Optional

import torch

SPAN_PREFIX = "hirest."
MAX_SPANS = 1 << 16  # records kept; the oldest go first


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # time.time_ns(), the profiler's clock
    end_ns: int
    thread: int  # threading.get_ident()
    span_id: int
    parent_id: Optional[int]
    trace_id: int
    attrs: dict


_records: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # the spans open on this thread, innermost last


_local = _Local()
_OFF = contextlib.nullcontext()
# whether a torch.profiler session records this thread: a flag read, no
# allocation (torch.autograd.profiler's own check)
_recording = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "trace_id",
                 "_range", "_start")

    def __init__(self, name: str, attrs: dict, parent):
        self.name, self.attrs = name, attrs
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = (parent.trace_id if parent is not None
                         else self.span_id)

    def __enter__(self):
        self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self._range.__enter__()
        _local.stack.append(self)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        self._range.__exit__(*exc)
        _records.append(SpanRecord(self.name, self._start, end,
                                   threading.get_ident(), self.span_id,
                                   self.parent_id, self.trace_id,
                                   self.attrs))
        return False


def span(name: str, **attrs):
    """A span named `name` around the block, under a profiler or inside an
    open span of this thread; else the shared null context."""
    stack = _local.stack
    if not stack and not _recording():
        return _OFF
    return _Span(name, attrs, stack[-1] if stack else None)


def current():
    """The innermost span open on this thread, or None."""
    stack = _local.stack
    return stack[-1] if stack else None


@contextlib.contextmanager
def adopt(parent):
    """Open `parent`, a span of another thread (`current()` there), on this
    thread for the block: the spans opened here are its children. A no-op
    for None."""
    if parent is None:
        yield
        return
    _local.stack.append(parent)
    try:
        yield
    finally:
        _local.stack.pop()


def spans() -> list:
    """The recorded spans, oldest first (the last MAX_SPANS)."""
    return list(_records)


def clear_spans() -> None:
    _records.clear()


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            with span("train." + name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def report(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 3),
                       "count": self.counts[name],
                       "mean_ms": round(1000 * self.totals[name] / max(1, self.counts[name]), 2)}
                for name in self.totals}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """torch.profiler trace of the CPU and, where there is one, the CUDA
    device while the block runs, written to `trace_dir` as a Chrome trace
    when it is set; a no-op otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


class MetricsLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, **metrics) -> None:
        if self._f is None:
            return
        rec = {"step": step, "ts": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
