"""Spans around the calls into each layer, and the device's timeline from
torch.profiler.

The harness marks its own calls into the program (`span`): the window, and
inside it what the system's loop names (systems/__init__.py), such as each
request and each call into the program. Untraced, a span costs nothing.
Traced, each is a `record_function` range on the profiler's clock, so the
device's operations and the host's spans share one timeline.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"
# outside every span of the harness (never inside the window)
NO_SPAN = SPAN_PREFIX + "none"
# device operations that are not kernels: the copy engines' work
NOT_KERNELS = ("Memcpy", "Memset")


def _union(intervals, lo: int, hi: int) -> list:
    """Sorted disjoint [start, end] of the intervals' union within [lo,
    hi)."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


@dataclass
class Timeline:
    """The traced window: device operations (kernels, copies, sets) and
    the harness's spans, in nanoseconds on the profiler's clock."""
    window: tuple
    ops: list = field(default_factory=list)  # (start, end, name)
    spans: list = field(default_factory=list)  # (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which any operation (a kernel, a copy, a
        set) ran on the device."""
        return sum(e - s for s, e in _union(
            ((s, e) for s, e, _ in self.ops), *self.window)) / 1e9

    def kernel_intervals(self) -> list:
        """The union of the kernels' intervals inside the window, as sorted
        disjoint [start, end]."""
        return _union(((s, e) for s, e, n in self.ops
                       if not n.startswith(NOT_KERNELS)), *self.window)

    def kernel_s(self) -> float:
        return sum(e - s for s, e in self.kernel_intervals()) / 1e9

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with no kernel on the
        device."""
        gaps, t = [], self.window[0]
        for s, e in self.kernel_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def device_time_by_name(self) -> dict:
        out = {}
        for s, e, name in self.ops:
            out[name] = out.get(name, 0) + (e - s)
        return {k: v / 1e9 for k, v in out.items()}

    def spans_named(self, name: str) -> list:
        return sorted((s, e) for s, e, n in self.spans if n == name)

    def labels(self, times) -> list:
        """For each of the sorted times, the innermost harness span the host
        was in then (NO_SPAN outside them all). Spans nest, as the harness's
        context managers on one thread make them."""
        spans = sorted(self.spans, key=lambda sp: (sp[0], -sp[1]))
        out, stack, j = [], [], 0
        for t in times:
            while j < len(spans) and spans[j][0] <= t:
                while stack and stack[-1][1] <= spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out.append(stack[-1][2] if stack else NO_SPAN)
        return out


class Tracer:
    """torch.profiler over the window (CPU and CUDA activity), or nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def timeline(self) -> Timeline:
        """The device's operations and the harness's spans of the traced
        window, read from the profiler's raw events."""
        from torch.autograd import DeviceType

        ops, spans = [], []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                if not ev.is_user_annotation():
                    ops.append((ev.start_ns(), ev.end_ns(), ev.name()))
            elif ev.name().startswith(SPAN_PREFIX):
                spans.append((ev.start_ns(), ev.end_ns(), ev.name()))
        windows = [(s, e) for s, e, n in spans if n == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} window spans")
        return Timeline(windows[0], ops, spans)
