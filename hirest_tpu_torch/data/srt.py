"""Minimal SRT subtitle parser (the `srt` pip package is not vendored).

An own copy of hirest_tpu/data/srt.py (the port imports nothing of the JAX package).

Produces (start_seconds, end_seconds, text) tuples with integer-truncated
second values, matching how the reference consumes `srt` — it reads
`sub.start.seconds` / `sub.end.seconds`, i.e. whole seconds
(hirest_dataset.py:377-380).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_TS = re.compile(r"(\d+):(\d+):(\d+)[,.](\d+)")


@dataclass(frozen=True)
class Subtitle:
    index: int
    start: float  # seconds
    end: float
    text: str

    @property
    def start_seconds(self) -> int:
        return int(self.start)

    @property
    def end_seconds(self) -> int:
        return int(self.end)


def _parse_ts(ts: str) -> float:
    m = _TS.search(ts)
    if not m:
        raise ValueError(f"bad SRT timestamp: {ts!r}")
    h, mnt, s, ms = m.groups()
    return int(h) * 3600 + int(mnt) * 60 + int(s) + int(ms.ljust(3, "0")[:3]) / 1000.0


def parse_srt(content: str) -> list[Subtitle]:
    subs: list[Subtitle] = []
    blocks = re.split(r"\n\s*\n", content.strip().replace("\r\n", "\n"))
    for block in blocks:
        lines = [ln for ln in block.split("\n") if ln.strip()]
        if len(lines) < 2:
            continue
        # first line may be the numeric index
        idx_line = 0
        index = len(subs) + 1
        if "-->" not in lines[0]:
            try:
                index = int(lines[0].strip())
            except ValueError:
                pass
            idx_line = 1
        if idx_line >= len(lines) or "-->" not in lines[idx_line]:
            continue
        start_s, end_s = lines[idx_line].split("-->")
        text = "\n".join(lines[idx_line + 1:])
        subs.append(Subtitle(index=index, start=_parse_ts(start_s),
                             end=_parse_ts(end_s), text=text))
    return subs


def load_srt(path: str) -> list[Subtitle]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_srt(f.read())
