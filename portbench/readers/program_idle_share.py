"""The share of the traced window, in %, in which no kernel ran on the
device while the innermost program span open on the thread that drives
the device was one of the rule's `spans` (program_spans.py). That thread
is the one that opened most spans named the rule's `thread_of`. The idle
time is split instant by instant, not put down to the span open where
each gap began. None where the program recorded no such spans."""

from portbench import program_spans


def read(rule, record):
    t = record.timeline
    if t is None or not t.kernel_intervals():
        return None
    idle = program_spans.idle_by_span(t, program_spans.records(record),
                                      rule["thread_of"])
    if idle is None:
        return None
    names = set(rule["spans"])
    ns = sum(v for name, v in idle.items() if name in names)
    return 100.0 * ns / (t.window[1] - t.window[0])
