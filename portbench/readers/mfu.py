"""The traced window's share, in %, of the chip's peak: the least time at
peak of the useful work of the requests it finished (the rule's `work`,
under portbench/work/), over the window. Padding slots and recomputed work
count for nothing, so it cannot pass 100."""

from portbench import registry


def read(rule, record):
    t = record.timeline
    if t is None or not t.ops:
        return None
    least = registry.work(rule["work"], record.root or registry.ROOT)(
        record.config, record.traffic, record.window)
    return 100.0 * least / t.window_s
