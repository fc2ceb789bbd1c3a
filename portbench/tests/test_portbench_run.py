"""A run end to end on the CPU at a tiny size: its result line, its
readers on a made-up trace, the faults it has to catch, its refusals, and
on a card a whole short run."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import registry, run, trace
from portbench.readers import idle_share, mfu, roofline, span_gap_ms
from portbench.records import Record, Window
from portbench.systems import eva_extract
from portbench.tests.tiny import SEED, tiny_cell
from portbench.work import eva_vision

ROOT = str(registry.ROOT)
CELLS = ["eva-clip-g14-int8.corpus", "eva-clip-g14-bf16.corpus",
         "eva-clip-g14-int8.clips"]


@pytest.mark.parametrize("name", CELLS)
def test_result_line_has_the_contracts_keys(name, monkeypatch):
    cell = tiny_cell(name)
    out = run.run_cell(cell, SEED, 1.0, False, "cpu")  # several videos
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(run, "card", lambda: "card, 700.00 W")
    line = json.loads(json.dumps(run.result_line(cell, out, False)))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0
               for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"rows_wrong", "excess_gap"}


def _timeline():
    """Two videos: kernels [0, 10) and [12, 20) ms in the first, a 5 ms
    gap around its end at 21 ms in which the next batch's 2 ms copy runs,
    then [25, 40) ms; window [0, 50) ms."""
    ms = 1_000_000
    ops = [(0, 10 * ms, "void int8_gemm_kernel<0>()"),
           (12 * ms, 20 * ms, "void fused_mlp_int8_out_kernel()"),
           (22 * ms, 24 * ms, "Memcpy HtoD (Pageable -> Device)"),
           (25 * ms, 40 * ms, "void int8_gemm_kernel<0>()")]
    spans = [(0, 50 * ms, trace.WINDOW), (0, 21 * ms, trace.SPAN_PREFIX
                                          + "video"),
             (21 * ms, 45 * ms, trace.SPAN_PREFIX + "video"),
             (1 * ms, 19 * ms, trace.SPAN_PREFIX + "apply"),
             (20 * ms, 21 * ms, trace.SPAN_PREFIX + "finish")]
    return trace.Timeline((0, 50 * ms), ops, spans)


def test_readers_on_a_made_up_trace():
    cell = tiny_cell("eva-clip-g14-int8.clips")
    t = _timeline()
    window = Window(0.0, 0.05, [eva_extract.Video(20, 0.03)], 3)
    rec = Record(cell.config, cell.traffic, 1.0, window, t)
    assert t.busy_s() == pytest.approx(0.035)  # the copy is an operation
    assert t.kernel_s() == pytest.approx(0.033)  # but no kernel
    assert idle_share.read({}, rec) == pytest.approx(34.0)
    assert span_gap_ms.read({"span": "video"}, rec) == pytest.approx(5.0)
    rule = {"kernels": ["int8_gemm"], "work": "eva_vision.g1_qkv_out"}
    least = eva_vision.g1_qkv_out(cell.config, cell.traffic, window)
    assert least == pytest.approx(3 * eva_vision.g1_qkv_out(
        cell.config, cell.traffic, Window(0.0, 1.0, [], 1)))
    assert roofline.read(rule, rec) == pytest.approx(100 * least / 0.025)
    assert roofline.read(dict(rule, kernels=["absent"]), rec) is None
    assert mfu.read({"work": "eva_vision.useful"}, rec) == pytest.approx(
        100 * 20 * eva_vision.frame_seconds_at_peak(cell.config) / 0.05)
    labels = run.breakdown(t)["idle_gaps"]
    assert labels == [[trace.SPAN_PREFIX + "video", pytest.approx(0.010)],
                      [trace.SPAN_PREFIX + "finish", pytest.approx(0.005)],
                      [trace.SPAN_PREFIX + "apply", pytest.approx(0.002)]]
    ops = dict(run.breakdown(t)["device_ops"])
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(0.002)


def test_labels_are_the_innermost_span():
    ms = 1_000_000
    t = _timeline()
    assert t.labels([0, 5 * ms, 19 * ms, 20 * ms, 21 * ms, 46 * ms,
                     60 * ms]) == [
        trace.SPAN_PREFIX + "video", trace.SPAN_PREFIX + "apply",
        trace.SPAN_PREFIX + "video", trace.SPAN_PREFIX + "finish",
        trace.SPAN_PREFIX + "video", trace.WINDOW, trace.NO_SPAN]


def _with_apply(monkeypatch, wrap):
    build = eva_extract.build_apply
    monkeypatch.setattr(eva_extract, "build_apply",
                        lambda *a, **k: wrap(build(*a, **k)))


def _altered(apply):
    def f(imgs):
        out = apply(imgs)
        return out + 0.5 * out.abs().mean() * torch.randn_like(out)
    return f


def _stale(apply):
    last = []

    def f(imgs):
        out = apply(imgs)
        last.append(out)
        return last[0]
    return f


def _short(apply):
    def f(imgs):
        return apply(imgs)[:-1]
    return f


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_altered, _stale, _short],
                         ids=["answer_altered", "state_unchanged",
                              "row_left_out"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    """An answer altered where it is produced, the first batch's answers
    served for every later batch, a row left out: each comes out as not
    correct."""
    _with_apply(monkeypatch, fault)
    out = run.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu")
    assert out["correct"] is False


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"hirest_tpu_torch": 1, "hirest_tpu_torch.ops": 1, "jaxtyping": 1,
            "hirest_tpu.models": 1, "jax.numpy": 1, "flax": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == ["flax", "hirest_tpu.models",
                                          "jax.numpy"]


def test_nothing_the_run_imports_is_jax_or_the_jax_package():
    code = ("import importlib, pkgutil, portbench\n"
            "for m in pkgutil.walk_packages(portbench.__path__, "
            "'portbench.'):\n"
            "    importlib.import_module(m.name)\n"
            "from portbench import run\n"
            "from portbench.tests.tiny import tiny_cell\n"
            "for name in ('eva-clip-g14-int8.corpus', "
            "'eva-clip-g14-bf16.corpus'):\n"
            "    run.run_cell(tiny_cell(name), 5, 0.2, True, 'cpu')\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=ROOT).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_without_a_card_it_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name, cuda_card):
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        name, "--seed", str(SEED), "--seconds", "3",
                        "--trace", "1"], capture_output=True, text=True,
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
    assert np.isfinite(line["device"]["memory_peak_bytes"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS[:2])
def test_the_control_is_not_correct_on_the_card(name, cuda_card):
    """The configuration's control in the program's place, at the cell's
    own size, through the harness's own comparison."""
    r = subprocess.run([sys.executable, "-m", "portbench.calibrate",
                        "--workload", name, "--control-seeds", str(SEED),
                        "--seconds", "2"], capture_output=True, text=True,
                       cwd=ROOT, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    reading = json.loads(r.stdout.strip().splitlines()[-1])
    assert reading["side"] == "control" and reading["correct"] is False
