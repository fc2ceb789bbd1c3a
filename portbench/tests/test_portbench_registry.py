"""BENCHMARK.json against the contract's shape, and discovery by name: a
new configuration, mix or metric is found from new files and entries
alone."""

import copy
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import inputs, registry, run, trace
from portbench.records import Record, Window
from portbench.tests.tiny import SEED, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def test_benchmark_keys_and_names():
    b = registry.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + CELLS + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_and_reports(name):
    cell = registry.cell(name, registry.benchmark())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert hasattr(registry.system(cell.config), "System")
    for m in cell.end_to_end + cell.per_layer:
        rule = registry.metric_rule(m["name"])
        assert hasattr(registry.reader(rule["reader"]), "read")
        if "work" in rule:
            assert callable(registry.work(rule["work"]))
    for m in cell.per_layer:  # their files say the same
        rule = registry.metric_rule(m["name"])
        assert [rule[k] for k in ("layer", "source", "moves")] == [
            m[k] for k in ("layer", "source", "moves")]


def _copy_tree(tmp: Path) -> dict:
    """The benchmark's files under tmp, and the digests of all but
    BENCHMARK.json (which gains entries)."""
    root = registry.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(root / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return {p: hashlib.sha256(p.read_bytes()).digest()
            for p in tmp.rglob("*")
            if p.is_file() and p.name != "BENCHMARK.json"}


def _write(path: Path, obj) -> None:
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


# a system of another kind, written as a new file: a matrix product served
# to requests of `n` rows, checked against float64
TOY_SYSTEM = """
import time
import torch
from portbench.records import Request, Verdict, Window


class System:
    def __init__(self, cfg, traffic, seed, device, control=False):
        g = torch.Generator().manual_seed(seed)
        self.w = torch.randn(cfg["width"], cfg["width"], generator=g)
        self.x = torch.randn(traffic["rows"], cfg["width"], generator=g)
        self.scale = 2.0 if control else 1.0

    def run(self, seconds, tracer):
        win = Window(time.perf_counter())
        while True:
            t0 = time.perf_counter()
            with tracer.span("request"):
                self.y = self.scale * (self.x @ self.w)
            win.steps += 1
            win.requests.append(Request(len(self.x),
                                        time.perf_counter() - t0))
            if time.perf_counter() >= win.start + seconds:
                win.end = time.perf_counter()
                return win

    def release(self):
        pass

    def check(self, window):
        want = self.x.double() @ self.w.double()
        gap = float((self.y.double() - want).abs().max())
        return Verdict({"max_gap": (gap, 1e-3)}, failed=0)
"""

TOY_WORK = """
def rows(cfg, traffic, window):
    return window.steps * 2 * traffic["batch"] * cfg["width"] ** 2 / 989e12
"""

TOY_READER = """
def read(rule, record):
    return float(record.window.steps * rule["times"])
"""


@pytest.mark.parametrize("kind", ["config", "mix", "metric", "reader",
                                  "system"])
def test_new_file_is_found_without_editing_any(tmp_path, kind):
    """A configuration (here without the uint8 front end), a mix, a metric
    with its own count of work, a reader, and a system of another kind are
    each found from new files and entries alone, and run."""
    before = _copy_tree(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    base = bench["workloads"][0]
    pkg = tmp_path / "portbench"
    cfg = json.loads((pkg / "configs" / "eva-clip-g14-int8.json")
                     .read_text())
    new = dict(base, name="new.cell")
    new_cfg = None
    if kind == "config":
        new_cfg = dict(cfg, flags={k: v for k, v in cfg["flags"].items()
                                   if k != "uint8_input"})
    elif kind == "mix":
        traffic = json.loads((pkg / "traffic" / "clips.json").read_text())
        _write(pkg / "traffic" / "new-mix.json",
               dict(traffic, length_s={"quantiles": [3, 9, 20]}))
        new["traffic"] = "new-mix"
    elif kind == "metric":
        _write(pkg / "work" / "new_work.py", TOY_WORK)
        _write(pkg / "metrics" / "new_roofline.json",
               {"reader": "roofline", "kernels": ["new_kernel"],
                "work": "new_work.rows", "layer": "x",
                "source": "device_trace", "moves": "frames_per_s"})
    elif kind == "reader":
        _write(pkg / "readers" / "new_reader.py", TOY_READER)
        _write(pkg / "metrics" / "new_count.json",
               {"reader": "new_reader", "times": 3, "layer": "x",
                "source": "program_counter", "moves": "frames_per_s"})
    else:
        _write(pkg / "systems" / "new_system.py", TOY_SYSTEM)
        _write(pkg / "traffic" / "rows.json", {"rows": 64})
        new_cfg = {"system": "new_system", "width": 32}
        new["traffic"] = "rows"
    if new_cfg is not None:
        _write(pkg / "configs" / "new-config.json", new_cfg)
        bench["configs"].append(dict(bench["configs"][0], name="new-config",
                                     file="portbench/configs/"
                                          "new-config.json"))
        new["config"] = "new-config"
    if kind in ("metric", "reader"):
        name = {"metric": "new_roofline", "reader": "new_count"}[kind]
        bench["per_layer"].append({"name": name, "unit": "%",
                                   "better": "higher",
                                   "source": "device_trace", "layer": "x",
                                   "moves": "frames_per_s",
                                   "workloads": ["new.cell"]})
    bench["workloads"].append(new)
    for m in bench["end_to_end"]:  # the new cell reports frames_per_s
        if m["name"] == "frames_per_s":
            m["workloads"].append("new.cell")
    _write(tmp_path / "BENCHMARK.json", bench)

    cell = registry.cell("new.cell", bench, tmp_path)
    if kind == "config":
        assert "uint8_input" not in cell.config["flags"]
        tiny = copy.deepcopy(cell)
        tiny.config.update(TINY)
        tiny.config["check"].update(frames=16, frame_tolerance=0.05)
        tiny.config["check"]["limits"]["excess_gap"] = 0.1
        tiny.traffic.update(batch=8, frame_pool=16)
        tiny.traffic["length_s"].update(low=5, high=30)
        out = run.run_cell(tiny, SEED, 0.3, False, "cpu")
        assert out["correct"], out["checks"]
    elif kind == "mix":
        assert inputs.video_lengths(cell.traffic) == [3, 9, 20]
    elif kind in ("metric", "reader"):
        tl = trace.Timeline((0, 10 ** 9), ops=[(0, 5 * 10 ** 8,
                                                "void new_kernel<1>()")])
        rec = Record(cell.config, cell.traffic, 1.0,
                     Window(0.0, 1.0, [], 2), tl, tmp_path)
        got = registry.read_metrics(cell.per_layer, rec, tmp_path)
        if kind == "metric":
            assert got["new_roofline"]["value"] == pytest.approx(
                100 * 2 * 2 * 128 * 1408 ** 2 / 989e12 / 0.5)
        else:
            assert got["new_count"]["value"] == 6.0
    else:
        out = run.run_cell(cell, SEED, 0.05, True, "cpu")
        assert out["correct"] and out["attempted"] >= 1
        assert set(out["metrics"]) == set()  # no per-layer metric listed
        out = run.run_cell(cell, SEED, 0.05, False, "cpu")
        assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
        assert not run.run_cell(cell, SEED, 0.05, False, "cpu",
                                control=True)["correct"]
    after = {p: hashlib.sha256(p.read_bytes()).digest() for p in before}
    assert after == before
