"""The units of work (frames, tokens, rows) of the requests the window
finished, over the window: from its start to the end of the first request
that finished after `--seconds`. Padding does not count."""


def read(rule, record):
    w = record.window
    return sum(r.n for r in w.requests) / w.seconds
