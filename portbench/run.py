"""Run one cell of the port's benchmark once; print its result as the last
line of standard output.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration names its system (systems/<system>.py). Set-up
is that system's: it makes the inputs from the seed, builds the program
with the configuration's flags and warms the shapes the traffic uses. The
window then drives the program for `--seconds`. Once it has closed, the
run reads the device's peak memory, frees the program and has the system
hold what the window produced to the plain reference (references/). With
`--trace 1` the window runs under torch.profiler and the line carries the
cell's per-layer metrics and a breakdown; otherwise its end-to-end metrics.

It needs the cards the cell asks for, and exits non-zero without a result
when they are not there, when the program cannot be imported, or when JAX
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on time.perf_counter's clock (10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return time.perf_counter()
    return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


PROCESS_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import registry, trace  # noqa: E402
from portbench.records import Record  # noqa: E402

# top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "hirest_tpu")
TOP_OPS = 10  # entries of each breakdown list


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (hirest_tpu_torch is neither)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def breakdown(t: trace.Timeline) -> dict:
    """The device operations that took most time, and the time with no
    kernel on the device by the innermost harness span the host was in when
    each idle stretch began."""
    ops = sorted(t.device_time_by_name().items(), key=lambda kv: -kv[1])
    gaps = t.idle_gaps()
    idle = {}
    for (g0, g1), name in zip(gaps, t.labels([g0 for g0, _ in gaps])):
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    top = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:TOP_OPS]],
            "idle_gaps": [[n, s] for n, s in top[:TOP_OPS]]}


def run_cell(cell: registry.Cell, seed: int, seconds: float, traced: bool,
             device, start: float = PROCESS_START,
             control: bool = False) -> dict:
    """One run of `cell` on `device` through the system its configuration
    names (systems/__init__.py); its result line as a dict (without
    `device`, which the caller adds). With `control` the configuration's
    control takes the program's place."""
    system = registry.system(cell.config, cell.root).System(
        cell.config, cell.traffic, seed, device, control=control)
    setup_s = time.perf_counter() - start

    tracer = trace.Tracer(traced)
    with tracer:
        with tracer.span("window"):
            window = system.run(seconds, tracer)
    timeline = tracer.timeline() if traced else None
    del tracer
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    system.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    verdict = system.check(window)
    record = Record(cell.config, cell.traffic, setup_s, window, timeline,
                    cell.root)
    metrics = registry.read_metrics(cell.per_layer if traced
                                    else cell.end_to_end, record, cell.root)
    out = {"correct": verdict.correct,
           "attempted": len(window.requests),
           "failed": verdict.failed,
           "metrics": metrics,
           "memory_peak_bytes": peak}
    if timeline is not None:
        out["busy_s"] = timeline.busy_s()
        out["window_s"] = timeline.window_s
        out["breakdown"] = breakdown(timeline)
    out["detail"] = verdict.detail
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in verdict.numbers.items()}
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result_line(cell: registry.Cell, out: dict, traced: bool) -> dict:
    """The contract's line: correct, attempted, failed, metrics, device,
    with --trace 1 a breakdown, then the card, and the numbers compared
    last."""
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    if traced:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = dev
    if traced:
        line["breakdown"] = out["breakdown"]
    line["card"] = card()
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = registry.cell(a.workload, registry.benchmark())
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the measuring process loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result_line(cell, out, bool(a.trace))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
