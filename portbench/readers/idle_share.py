"""The share of the traced window, in %, in which no kernel ran on the
device: one minus the union of the kernels' intervals over the window.
Copies and sets do not count as busy: while the host's copy of a batch
runs, the SMs wait on it."""


def read(rule, record):
    t = record.timeline
    if t is None or not t.kernel_intervals():
        return None
    return 100.0 * (1.0 - t.kernel_s() / t.window_s)
