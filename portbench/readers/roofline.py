"""A kernel's share of its roofline, in %: the least time at peak of the
work the rule's `work` counts (under portbench/work/: what the kernels
were given in every step the window ran, padding included), over the
device time of every operation whose name holds one of the rule's
`kernels` and none of its `exclude`. None where no such operation ran."""

from portbench import registry


def read(rule, record):
    t = record.timeline
    if t is None or not t.ops:
        return None
    keys, skip = rule["kernels"], rule.get("exclude", ())
    busy = sum(s for name, s in t.device_time_by_name().items()
               if any(k in name for k in keys)
               and not any(x in name for x in skip))
    if busy <= 0:
        return None
    least = registry.work(rule["work"], record.root or registry.ROOT)(
        record.config, record.traffic, record.window)
    return 100.0 * least / busy
