"""The readers of a program's own spans (program_spans.py,
readers/program_idle_share.py, program_span_ms.py, program_span_rate.py)
on a made-up trace with made-up program records, a made-up system that
brings spans of its own, the cells and entries that use them, and a
traced run of a clips cell on the CPU; on the card, the port's records
against the window's steps and the profiler's ranges, and a span's
cost."""

import json
import statistics
import threading
import time

import pytest

from portbench import program_spans, registry, run, trace
from portbench.readers import (program_idle_share, program_span_ms,
                               program_span_rate)
from portbench.records import Record, Window
from portbench.tests.tiny import SEED, tiny_cell

MS = 1_000_000
FWD, PRODUCER = 1, 2  # thread ids: the loop's, the prefetch thread's
NEW_CELL = "eva-clip-g14-bf16.clips"
IDLE = ("fetch", "normalise", "prefetch", "copy_in")
CLIPS = {f"idle_share.{k}.clips" for k in IDLE} | {
    "prefetch_wait_ms.clips", "copy_in_ms.clips", "copy_in_gb_per_s.clips"}
FORWARD = "eva.forward"


def rec(name, start_ms, end_ms, thread=FWD, **attrs):
    return program_spans.Span(int(start_ms * MS), int(end_ms * MS), name,
                              thread, attrs)


# the loop's thread, nested as its context managers nest them, then the
# prefetch thread's (never counted: it does not drive the forwards)
RECORDS = [
    rec("eva.copy_in", 5, 12), rec("eva.forward", 12, 14),
    rec("features.fetch", 30, 44), rec("features.normalise", 44, 47),
    rec("extract.video", 48, 100), rec("prefetch.start", 50, 52),
    rec("prefetch.wait", 52, 58), rec("eva.copy_in", 58, 62),
    rec("eva.forward", 62, 64),
    rec("features.fetch", 0, 100, PRODUCER),
    rec("prefetch.produce", 20, 70, PRODUCER),
]
# kernels [10, 40) and [60, 90) ms: idle [0, 10), [40, 60), [90, 100); a
# copy, which is no kernel, in the second gap
OPS = [(10 * MS, 40 * MS, "void int8_gemm_kernel<0>()"),
       (55 * MS, 57 * MS, "Memcpy HtoD (Pageable -> Device)"),
       (60 * MS, 90 * MS, "void fused_mlp_int8_out_kernel()")]
# the idle ms under each innermost span of the loop's thread, by hand
WANT = {None: 6, "eva.copy_in": 7, "features.fetch": 4,
        "features.normalise": 3, "extract.video": 12, "prefetch.start": 2,
        "prefetch.wait": 6}


def _timeline():
    spans = [(0, 100 * MS, trace.WINDOW),
             (0, 47.5 * MS, trace.SPAN_PREFIX + "video"),
             (47.5 * MS, 100 * MS, trace.SPAN_PREFIX + "video")]
    return trace.Timeline((0, 100 * MS), OPS, spans)


def _record(timeline):
    cell = tiny_cell("eva-clip-g14-int8.clips")
    return Record(cell.config, cell.traffic, 1.0, Window(0.0, 0.1, [], 2),
                  timeline)


@pytest.fixture
def made_up(monkeypatch):
    found = list(RECORDS)
    monkeypatch.setattr(program_spans, "recorded", lambda record: found)
    return found


def _rule(name):
    return registry.metric_rule(name)


def test_idle_is_split_instant_by_instant_across_nested_spans(made_up):
    t = _timeline()
    r = _record(t)
    idle = program_spans.idle_by_span(t, program_spans.records(r), FORWARD)
    assert {k: v / MS for k, v in idle.items()} == pytest.approx(WANT)
    # every idle instant is under one span or outside them all
    assert sum(idle.values()) == pytest.approx(
        t.window_s * 1e9 - t.kernel_s() * 1e9)
    want = {"fetch": 4, "normalise": 3, "prefetch": 8, "copy_in": 7}
    for key in IDLE:
        for suffix in ("", ".clips"):
            got = program_idle_share.read(_rule(f"idle_share.{key}{suffix}"),
                                          r)
            assert got == pytest.approx(want[key]), key


def test_only_the_thread_that_drives_the_forwards_counts(made_up):
    t = _timeline()
    # the prefetch thread's features.fetch covers the whole window; the
    # loop's covers 4 ms of idle
    assert program_idle_share.read(_rule("idle_share.fetch"),
                                   _record(t)) == pytest.approx(4.0)
    made_up[:] = [r for r in made_up if r.thread == PRODUCER]
    assert program_spans.driving_thread(program_spans.records(_record(t)),
                                        FORWARD) is None
    assert program_idle_share.read(_rule("idle_share.fetch"),
                                   _record(t)) is None


def test_records_outside_the_window_are_dropped(made_up):
    t = _timeline()
    r = _record(t)
    before = {k: program_idle_share.read(_rule(f"idle_share.{k}"), r)
              for k in IDLE}
    made_up += [rec("eva.copy_in", -20, -10), rec("eva.forward", -9, -8),
                rec("eva.copy_in", 110, 120), rec("prefetch.wait", 100, 105)]
    assert len(program_spans.records(r)) == len(RECORDS)
    assert {k: program_idle_share.read(_rule(f"idle_share.{k}"), r)
            for k in IDLE} == before
    made_up[:] = [rec("eva.copy_in", -5, 3), rec("eva.copy_in", 98, 130)]
    straddle = program_spans.records(r)
    assert [(s.start, s.end) for s in straddle] == [(0, 3 * MS),
                                                    (98 * MS, 100 * MS)]


def test_nothing_to_read_without_records(monkeypatch):
    from hirest_tpu_torch.utils import profiling

    monkeypatch.setattr(program_spans, "recorded", lambda record: [])
    r = _record(_timeline())
    names = sorted(CLIPS) + [f"idle_share.{k}" for k in IDLE]
    for name in names:
        rule = _rule(name)
        assert registry.reader(rule["reader"]).read(rule, r) is None, name
    monkeypatch.undo()
    # a port without spans, as the parent of the spans has it
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.recorded(r) == []
    # a system that brings no spans module
    other = Record({"system": "no_such_system"}, {}, 1.0, r.window,
                   r.timeline)
    assert program_spans.recorded(other) == []
    untraced = Record({}, {}, 1.0, Window(0.0, 1.0), None)
    assert program_span_ms.read(_rule("copy_in_ms.clips"), untraced) is None


def test_the_percentile_is_over_the_requests(monkeypatch):
    """Twenty requests of 10 ms; each has its copies summed, one copy
    straddles two requests and is split between them."""
    spans = [(0, 200 * MS, trace.WINDOW)] + [
        (i * 10 * MS, (i + 1) * 10 * MS, trace.SPAN_PREFIX + "video")
        for i in range(20)]
    found = [rec("eva.copy_in", i * 10 + 1, i * 10 + 1 + 0.1 * (i + 1))
             for i in range(20)]
    found += [rec("eva.copy_in", 35, 36), rec("eva.copy_in", 49, 52),
              rec("prefetch.wait", 70, 79)]  # not a copy
    monkeypatch.setattr(program_spans, "recorded", lambda record: found)
    want = [0.1 * (i + 1) for i in range(20)]
    want[3] += 1
    want[4] += 1
    want[5] += 2
    t = trace.Timeline((0, 200 * MS), [], spans)
    got = program_span_ms.read(_rule("copy_in_ms.clips"), _record(t))
    assert got == pytest.approx(statistics.quantiles(
        want, n=100, method="inclusive")[94])
    wait = program_span_ms.read(_rule("prefetch_wait_ms.clips"), _record(t))
    assert wait == pytest.approx(statistics.quantiles(
        [9.0 if i == 7 else 0.0 for i in range(20)], n=100,
        method="inclusive")[94])


def test_the_new_cell_and_entries_resolve():
    bench = registry.benchmark()
    new = registry.cell(NEW_CELL, bench)
    assert new.config["name"] == "eva-clip-g14-bf16"
    assert new.traffic == registry.cell("eva-clip-g14-int8.clips",
                                        bench).traffic
    assert {m["name"] for m in new.end_to_end} == {
        "video_ms_p50", "video_ms_p95", "setup_s"}
    clips = CLIPS
    assert {m["name"] for m in new.per_layer} == clips | {
        "video_gap_ms.clips", "idle_share.clips", "mfu.clips"}
    assert clips <= {m["name"] for m in registry.cell(
        "eva-clip-g14-int8.clips", bench).per_layer}
    corpus = {f"idle_share.{k}" for k in IDLE}
    for name in ("eva-clip-g14-int8.corpus", "eva-clip-g14-bf16.corpus"):
        assert corpus <= {m["name"] for m in registry.cell(
            name, bench).per_layer}
    for m in bench["per_layer"]:
        if m["name"] in clips | corpus:
            rule = registry.metric_rule(m["name"])
            assert rule["reader"] in ("program_idle_share",
                                      "program_span_ms", "program_span_rate")
            assert rule["spans"] and all("." in s for s in rule["spans"])
            if rule["reader"] == "program_idle_share":
                assert rule["thread_of"] == FORWARD
            assert m["source"] == "device_trace"


@pytest.mark.parametrize("name", ["eva-clip-g14-int8.clips", NEW_CELL])
def test_a_traced_run_records_a_forward_and_a_fetch_a_step(name):
    """On the CPU (no kernels, so no idle shares): every clip is one step,
    as in the mix (a batch holds the longest clip), with one eva.forward
    and one features.fetch of the loop's, and the per-request readers read
    them."""
    from hirest_tpu_torch.utils import profiling

    cell = tiny_cell(name)
    cell.traffic["batch"] = cell.traffic["length_s"]["high"]
    profiling.clear_spans()
    out = run.run_cell(cell, SEED, 0.5, True, "cpu")
    assert out["correct"] and out["attempted"] >= 3
    names = [r.name for r in profiling.spans()]
    assert names.count("eva.forward") == out["attempted"]
    assert names.count("features.fetch") == out["attempted"]
    assert names.count("prefetch.start") == out["attempted"]
    assert set(out["metrics"]) == {"prefetch_wait_ms.clips",
                                   "copy_in_ms.clips",
                                   "copy_in_gb_per_s.clips"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    profiling.clear_spans()


MADE_UP_SPANS = '''
from portbench.program_spans import Span

MS = 1_000_000


def program_spans():
    # a server's loop on thread 7 and a tokenizer's on thread 8
    return [Span(0, 30 * MS, "serve.step", 7, {}),
            Span(2 * MS, 8 * MS, "serve.schedule", 7, {}),
            Span(40 * MS, 70 * MS, "serve.step", 7, {}),
            Span(45 * MS, 60 * MS, "serve.schedule", 7, {}),
            Span(0, 100 * MS, "serve.schedule", 8, {})]
'''


def test_a_made_up_system_brings_its_own_spans(tmp_path):
    """A system of another kind gives its spans from systems/<system>_spans.py
    and its metric names the span that marks its loop's thread: the readers
    read both with no edit to program_spans.py."""
    (tmp_path / "portbench" / "systems").mkdir(parents=True)
    (tmp_path / "portbench" / "metrics").mkdir()
    (tmp_path / "portbench" / "systems" / "made_up_spans.py").write_text(
        MADE_UP_SPANS)
    (tmp_path / "portbench" / "metrics" / "idle_share.schedule.json"
     ).write_text(json.dumps({"reader": "program_idle_share",
                              "spans": ["serve.schedule"],
                              "thread_of": "serve.step"}))
    rule = registry.metric_rule("idle_share.schedule", tmp_path)
    t = trace.Timeline((0, 100 * MS), [(5 * MS, 50 * MS, "void step()")],
                       [(0, 100 * MS, trace.WINDOW)])
    r = Record({"system": "made_up"}, {}, 1.0, Window(0.0, 0.1), t, tmp_path)
    # idle [0, 5) and [50, 100): serve.schedule on thread 7 covers [2, 5)
    # and [50, 60); thread 8's whole-window span is not the loop's
    assert program_idle_share.read(rule, r) == pytest.approx(13.0)
    rule["thread_of"] = "serve.prefill"  # no such span: nothing to read
    assert program_idle_share.read(rule, r) is None


def test_the_rate_is_the_attribute_over_the_spans_seconds(made_up):
    rule = _rule("copy_in_gb_per_s.clips")
    assert (rule["spans"], rule["attr"]) == (["eva.copy_in"], "bytes")
    r = _record(_timeline())
    assert program_span_rate.read(rule, r) is None  # no bytes recorded
    made_up[:] = [rec("eva.copy_in", 5, 9, bytes=8_000_000),
                  rec("eva.copy_in", 20, 24, bytes=24_000_000),
                  rec("eva.copy_in", 30, 34),  # no bytes: not counted
                  rec("prefetch.wait", 40, 41, bytes=10 ** 12),
                  rec("eva.copy_in", 98, 102, bytes=10 ** 12)]  # straddles
    # 32 MB over 8 ms
    assert program_span_rate.read(rule, r) == pytest.approx(4.0)
    assert program_span_rate.read(
        rule, Record(r.config, {}, 1.0, r.window, None)) is None


def test_eva_extract_gives_the_ports_records():
    from hirest_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile

    eva_spans = registry.module("systems", "eva_extract_spans")
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("eva.copy_in") as s:
            s.attrs["bytes"] = 12
    (got,) = eva_spans.program_spans()
    (want,) = profiling.spans()
    assert got == program_spans.Span(want.start_ns, want.end_ns,
                                     "eva.copy_in", threading.get_ident(),
                                     {"bytes": 12})
    profiling.clear_spans()


CARD_CELLS = ["eva-clip-g14-int8.corpus", "eva-clip-g14-bf16.corpus",
              "eva-clip-g14-int8.clips", NEW_CELL]
CLOCK_NS = 200_000  # a record lies within its profiler range to 0.2 ms


def _clock(loop: list, ranges: dict) -> list:
    """For each record, the profiler range of its name ({name: [(start,
    end)]}) whose start is nearest: (ns outside that range, 0 inside; ns
    from its start to the record's start)."""
    import bisect

    out = []
    for sp in loop:
        mine = sorted(ranges[sp.name])
        i = bisect.bisect_right([s for s, _ in mine], sp.start)
        s, e = min((mine[j] for j in (i - 1, i) if 0 <= j < len(mine)),
                   key=lambda se: abs(se[0] - sp.start))
        out.append((max(0, s - sp.start, sp.end - e), sp.start - s))
    return out


@pytest.mark.card
@pytest.mark.parametrize("name", CARD_CELLS)
def test_the_ports_records_on_the_card(name, cuda_card):
    """A short traced window of the cell, as run_cell traces it: one
    eva.forward and one features.fetch record of the loop's thread a step,
    each loop record inside its own hirest.* range among the profiler's
    host events to 0.2 ms (median start gap under 0.1 ms), and the idle
    split by program span adding up to the window's idle. Prints what it
    measured."""
    from torch.autograd import DeviceType

    from hirest_tpu_torch.utils import profiling

    cell = registry.cell(name, registry.benchmark())
    system = registry.system(cell.config).System(
        cell.config, cell.traffic, SEED, cuda_card)
    profiling.clear_spans()
    tracer = trace.Tracer(True)
    with tracer:
        with tracer.span("window"):
            window = system.run(5.0, tracer)
    t = tracer.timeline()
    ranges = {}
    for ev in tracer._prof.profiler.kineto_results.events():
        if (ev.name().startswith(profiling.SPAN_PREFIX)
                and ev.device_type() != DeviceType.CUDA):
            ranges.setdefault(ev.name()[len(profiling.SPAN_PREFIX):],
                              []).append((ev.start_ns(), ev.end_ns()))
    system.release()
    r = Record(cell.config, cell.traffic, 0.0, window, t, cell.root)
    spans = program_spans.records(r)
    thread = program_spans.driving_thread(spans, FORWARD)
    assert thread == threading.get_ident()
    loop = [sp for sp in spans if sp.thread == thread]
    names = [sp.name for sp in loop]
    assert names.count(FORWARD) == window.steps
    assert names.count("features.fetch") == window.steps
    clock = _clock([sp for sp in program_spans.within(r)
                    if sp.thread == thread], ranges)
    outside = max(o for o, _ in clock)
    gap = statistics.median(g for _, g in clock)
    idle = program_spans.idle_by_span(t, spans, FORWARD)
    idle_ns = t.window_s * 1e9 - t.kernel_s() * 1e9
    print(json.dumps({"cell": name, "steps": window.steps,
                      "records": len(clock), "max_outside_us": outside / 1e3,
                      "median_start_gap_us": gap / 1e3,
                      "max_start_gap_us": max(g for _, g in clock) / 1e3,
                      "outside_every_span_of_idle": idle.get(None, 0)
                      / idle_ns}))
    assert outside <= CLOCK_NS and gap < CLOCK_NS / 2
    assert sum(idle.values()) == pytest.approx(idle_ns, rel=1e-9)
    profiling.clear_spans()


@pytest.mark.card
def test_a_span_costs_little_on_the_card(cuda_card):
    """A `with span(...)` block off costs under 2 us on the card's host (eight
    a batch of ~100 ms: under 0.02 %), and on, under torch.profiler with CPU
    and CUDA activity as the harness traces, under 50 us. Prints both."""
    from torch.profiler import ProfilerActivity, profile

    from hirest_tpu_torch.utils import profiling

    def per_call(n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = min(per_call() for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = min(per_call() for _ in range(3))
    profiling.clear_spans()
    print(json.dumps({"span_off_us": off, "span_on_us": on}))
    assert off < 2.0 and on < 50.0
