"""Readers of metrics. Each module has `read(rule, record)`: `rule` is the
metric's file under portbench/metrics/, `record` what the run saw
(records.Record):

- `record.config`, `record.traffic`: the cell's files;
- `record.setup_s`: the process's start to the window's start;
- `record.window`: records.Window, the requests finished (units of work,
  turnaround) and the steps run, by the host's clock;
- `record.timeline`: trace.Timeline of a `--trace 1` run, else None;
- `record.root`: where the benchmark's files are, for registry.work.

A reader that finds nothing to read returns None, and the run leaves that
metric out of its line. A new reader is a new module here.
"""
