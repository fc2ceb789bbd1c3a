"""What a run records, in the shapes every system and every reader share.

A system's window (systems/__init__.py) is a `Window`, or a subclass with
fields of its own; its requests are `Request`s, or subclasses. The readers
of metrics (readers/__init__.py) read only the fields named here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class Request:
    """One request the window finished: the units of work it carried
    (frames, tokens, rows) and its turnaround on the host's clock, from its
    hand-off to the system until its answer was on the host."""
    n: int
    seconds: float


@dataclass
class Window:
    """What the window did, by the host's clock: the requests it finished,
    in order, and the device steps (forwards, iterations) it ran."""
    start: float
    end: float = 0.0
    requests: list = field(default_factory=list)
    steps: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Verdict:
    """What the check found: {name: (value, limit)} of the numbers compared,
    the requests that failed, and what the check saw besides (such as each
    sampled answer's gap), for calibration."""
    numbers: dict
    failed: int
    detail: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        """Every number within its limit (a limit not yet set holds
        none)."""
        return all(limit is not None and v <= limit
                   for v, limit in self.numbers.values())


@dataclass
class Record:
    """What a run saw, for the metric readers."""
    config: dict
    traffic: dict
    setup_s: float
    window: Window
    timeline: Optional[object] = None  # trace.Timeline of a traced run
    root: Optional[Path] = None  # where the benchmark's files are
