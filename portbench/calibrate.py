"""Readings that a configuration's limits are set from, in one process on
the chip: the program's compared numbers on many seeds, and the control's
on a few.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 4] [--out file.jsonl]

Each seed is a whole run of the cell (run.run_cell) with a short window at
the cell's own load, through the harness's own comparison. A control seed
runs the configuration file's `check.control` in the program's place: its
system builds the program with that path of its own switched on (`flags`:
the bf16 configuration's int8 path), or puts the plain reference there
with codes of fewer levels (`qmax`: int4 for int8). The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import registry, run


def reading(cell: registry.Cell, seed: int, seconds: float, device,
            control: bool = False) -> dict:
    """A short run of the cell, or of its control in the program's place:
    its compared numbers and what its check saw besides."""
    out = run.run_cell(cell, seed, seconds, False, device,
                       start=time.perf_counter(), control=control)
    return {"correct": out["correct"],
            **{k: c["value"] for k, c in out["checks"].items()},
            **out["detail"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate needs a CUDA device", file=sys.stderr)
        return 3
    cell = registry.cell(a.workload, registry.benchmark())
    sink = open(a.out, "a") if a.out else None

    def emit(rec: dict) -> None:
        rec = {"workload": a.workload, **rec}
        print(json.dumps(rec), flush=True)
        if sink:
            sink.write(json.dumps(rec) + "\n")
            sink.flush()

    control = cell.config["check"]["control"]
    try:
        for s in filter(None, a.seeds.split(",")):
            emit({"side": "program", "seed": int(s),
                  **reading(cell, int(s), a.seconds, "cuda")})
        for s in filter(None, a.control_seeds.split(",")):
            emit({"side": "control", "seed": int(s), "control": control,
                  **reading(cell, int(s), a.seconds, "cuda", control=True)})
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
