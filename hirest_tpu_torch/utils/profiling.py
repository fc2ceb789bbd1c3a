"""Tracing / profiling / metrics observability.

Counterpart of hirest_tpu/utils/profiling.py: `PhaseTimer` and
`MetricsLogger` are copies; `trace` runs torch.profiler in place of
jax.profiler. The reference has none of this (SURVEY §5.1: tqdm bars and
prints only; a wandb flag that never logs, run.py:30,205-207). Here:

- PhaseTimer: accumulates wall-clock per named phase (data, train_step,
  eval, ...) for per-epoch reports;
- trace(): context manager around torch.profiler for on-demand device
  traces (a Chrome trace, viewable in Perfetto);
- MetricsLogger: append-only JSONL sink for scalar metrics (step, loss,
  lr, throughput) — greppable, plottable, no external service.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
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
    import torch
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
