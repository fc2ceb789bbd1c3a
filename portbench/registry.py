"""Finds what a cell is made of by the names in BENCHMARK.json: its
configuration file, the system that the configuration names
(`systems/<system>.py`), its traffic mix (`traffic/<mix>.json`), and for
each of its metrics the reading rule (`metrics/<metric>.json`), its reader
(`readers/<reader>.py`) and the work a share of a peak counts
(`work/<module>.py`). A new system, configuration, mix, metric or count of
work is a new file here and a new entry there; no existing file changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "portbench"  # the directory under the root that holds the files


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # BENCHMARK.json's metric entries this cell reports
    per_layer: list
    root: Path = ROOT  # where its files are


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: dict, root: Path = ROOT) -> Cell:
    """The cell `name` of `bench`, with its files read; KeyError if the
    benchmark has no such cell."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {', '.join(work)})")
    w = work[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name=name, config=load_json(root / config["file"]),
                traffic=load_json(root / PACKAGE / "traffic"
                                  / f"{w['traffic']}.json"),
                chips=w["chips"], end_to_end=e2e, per_layer=per_layer,
                root=Path(root))


def metric_rule(name: str, root: Path = ROOT) -> dict:
    return load_json(root / PACKAGE / "metrics" / f"{name}.json")


def module(kind: str, name: str, root: Path = ROOT):
    """The module `<root>/portbench/<kind>/<name>.py`: imported as
    portbench.<kind>.<name> from this checkout, and from its file where the
    benchmark's files lie elsewhere."""
    qual = f"{PACKAGE}.{kind}.{name}"
    if Path(root).resolve() == ROOT:
        return importlib.import_module(qual)
    path = Path(root) / PACKAGE / kind / f"{name}.py"
    key = f"{qual}@{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None:
            raise ModuleNotFoundError(f"no module {qual} at {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod  # before it runs: its dataclasses look it up
        spec.loader.exec_module(mod)
    return sys.modules[key]


def system(config: dict, root: Path = ROOT):
    """The system module the configuration names (systems/__init__.py)."""
    return module("systems", config["system"], root)


def reader(kind: str, root: Path = ROOT):
    """The module portbench.readers.<kind>, whose read(rule, record) gives
    the metric's value, or None where it finds nothing to read."""
    return module("readers", kind, root)


def work(spec: str, root: Path = ROOT):
    """The function `<module>.<function>` under portbench/work/: given the
    configuration, the traffic and the window, the least time in seconds
    that the work it counts takes at the peaks (work/__init__.py)."""
    mod, _, fn = spec.rpartition(".")
    return getattr(module("work", mod, root), fn)


def read_metrics(entries: list, record, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of each metric entry whose reader finds
    something to read."""
    out = {}
    for entry in entries:
        rule = metric_rule(entry["name"], root)
        value = reader(rule["reader"], root).read(rule, record)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out
