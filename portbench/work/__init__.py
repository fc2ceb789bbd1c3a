"""Counts of work, for shares of a peak or of a roofline. A metric's rule
names one as `"work": "<module>.<function>"` (registry.work); the function
takes (config, traffic, window) and gives the least time in seconds, at
the peaks of yardstick.py, that the work it counts took in the window: for
a kernel's roofline the work its kernels were given, padding included,
over every step the window ran; for a share of the chip's peak the useful
work of the requests the window finished. A new count is a new module
here, or a new function in a module a PR adds.
"""
