"""A percentile, in ms, over the requests of the traced window of the time
the program spent in the rule's `spans` inside each request: the named
program spans' time (program_spans.py) within each harness span
`portbench.<per>`, summed, then the rule's `percentile` of those sums.
None where the program recorded none of the spans, or fewer than two
requests were traced."""

import bisect
import statistics

from portbench import program_spans, trace


def read(rule, record):
    t = record.timeline
    if t is None:
        return None
    names = set(rule["spans"])
    spans = [sp for sp in program_spans.records(record) if sp.name in names]
    per = t.spans_named(trace.SPAN_PREFIX + rule["per"])
    if not spans or len(per) < 2:
        return None
    ends = [e for _, e in per]
    ns = [0] * len(per)
    for sp in spans:  # the requests' spans are disjoint: few overlap one
        i = bisect.bisect_right(ends, sp.start)
        while i < len(per) and per[i][0] < sp.end:
            ns[i] += max(0, min(sp.end, per[i][1]) - max(sp.start, per[i][0]))
            i += 1
    return statistics.quantiles([v / 1e6 for v in ns], n=100,
                                method="inclusive")[rule["percentile"] - 1]
