"""The program's own spans, read after a traced window.

A system whose program records spans of its own gives them through a
module beside it, `systems/<system>_spans.py`, whose `program_spans()`
returns them as `Span`s: start and end in `time.time_ns()` (the clock of
the profiler's events), name, the thread that opened it and its
attributes. A system without that module, or a program that records no
spans, gives no records, and the readers here nothing to read.

The readers take the records that overlap the window, clipped to it, and
split the device's idle time (trace.Timeline.idle_gaps) instant by
instant by the innermost program span open on the thread that drives the
device: the thread that opened most spans of the name the metric's rule
gives as `thread_of`.
"""

from __future__ import annotations

import bisect
from collections import Counter
from pathlib import Path
from typing import NamedTuple, Optional

from portbench import registry


class Span(NamedTuple):
    start: int
    end: int
    name: str
    thread: int
    attrs: dict  # counters the program read where the work happened


def recorded(record) -> list:
    """What the cell's system gives of its program's spans, or [] where it
    gives none."""
    root = Path(record.root or registry.ROOT)
    name = f"{record.config['system']}_spans"
    if not (root / registry.PACKAGE / "systems" / f"{name}.py").exists():
        return []
    return list(registry.module("systems", name, root).program_spans())


def within(record) -> list:
    """The program's spans that lie wholly inside the timeline's window."""
    lo, hi = record.timeline.window
    return [sp for sp in recorded(record) if lo <= sp.start <= sp.end <= hi]


def records(record) -> list:
    """The program's spans that overlap the timeline's window, clipped to
    it, by start."""
    lo, hi = record.timeline.window
    out = []
    for sp in recorded(record):
        s, e = max(sp.start, lo), min(sp.end, hi)
        if s < e or (s == e and lo <= sp.start < hi):
            out.append(sp._replace(start=s, end=e))
    return sorted(out, key=lambda sp: (sp.start, sp.end))


def driving_thread(spans: list, thread_of: str) -> Optional[int]:
    """The thread that opened most spans named `thread_of`, or None."""
    counts = Counter(sp.thread for sp in spans if sp.name == thread_of)
    return counts.most_common(1)[0][0] if counts else None


def innermost(spans: list, lo: int, hi: int) -> list:
    """(start, end, name) covering [lo, hi) in order: the innermost of the
    spans open then, None outside them all. The spans are one thread's,
    nested as context managers nest them."""
    out, stack, t = [], [], lo

    def emit(until, name):
        nonlocal t
        until = min(max(until, t), hi)
        if until > t:
            out.append((t, until, name))
            t = until

    for sp in sorted(spans, key=lambda sp: (sp.start, -sp.end)):
        while stack and stack[-1].end <= sp.start:
            top = stack.pop()
            emit(top.end, top.name)
        emit(sp.start, stack[-1].name if stack else None)
        stack.append(sp)
    while stack:
        top = stack.pop()
        emit(top.end, top.name)
    emit(hi, None)
    return out


def idle_by_span(timeline, spans: list, thread_of: str) -> Optional[dict]:
    """{program span name, or None outside them all: ns} of the window's
    kernel-idle time, by the innermost span open on the driving thread at
    each instant; None where no span is named `thread_of`."""
    thread = driving_thread(spans, thread_of)
    if thread is None:
        return None
    lo, hi = timeline.window
    segs = innermost([sp for sp in spans if sp.thread == thread], lo, hi)
    starts = [s for s, _, _ in segs]
    out: dict = {}
    for g0, g1 in timeline.idle_gaps():
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(segs) and segs[i][0] < g1:
            s, e, name = segs[i]
            d = min(e, g1) - max(s, g0)
            if d > 0:
                out[name] = out.get(name, 0) + d
            i += 1
    return out
