"""A rate over the traced window: the attribute `attr` of the rule's
program `spans` (program_spans.py) that lie wholly inside the window,
summed, over their summed seconds, times the rule's `scale` (1e-9 for
bytes gives GB/s). None where the program recorded no such span."""

from portbench import program_spans


def read(rule, record):
    if record.timeline is None:
        return None
    names = set(rule["spans"])
    spans = [sp for sp in program_spans.within(record)
             if sp.name in names and rule["attr"] in sp.attrs]
    ns = sum(sp.end - sp.start for sp in spans)
    if ns <= 0:
        return None
    total = sum(sp.attrs[rule["attr"]] for sp in spans)
    return total / (ns / 1e9) * rule["scale"]
