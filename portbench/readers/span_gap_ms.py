"""The median, in ms, of the device's idle gap (no kernel running) around
the end of each span the rule names but the last: for a request span, the
stretch between one request's last kernel and the next one's first, while
the host ends the one and starts the other. None with fewer than two such
spans traced."""

import bisect
import statistics

from portbench import trace


def read(rule, record):
    t = record.timeline
    if t is None or not t.ops:
        return None
    gaps = t.idle_gaps()
    starts = [g0 for g0, _ in gaps]
    found = []
    for _, end in t.spans_named(trace.SPAN_PREFIX + rule["span"])[:-1]:
        i = bisect.bisect_right(starts, end) - 1
        if i >= 0 and gaps[i][1] >= end:
            found.append((gaps[i][1] - gaps[i][0]) / 1e6)
    return statistics.median(found) if found else None
