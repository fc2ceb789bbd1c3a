"""A percentile of the requests' turnaround in ms: from the moment a
request is handed to the system until its answer is on the host, over
every request finished in the window."""

import statistics


def read(rule, record):
    ms = [r.seconds * 1e3 for r in record.window.requests]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[
        rule["percentile"] - 1]
