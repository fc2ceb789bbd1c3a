"""The port's spans (hirest_tpu_torch/utils/profiling.py) on the CPU: off
without a profiler, and under torch.profiler their names, nesting, parent
and trace ids, attributes and clock, on the extraction path's own calls
(the prefetch thread, the scanned tower's apply, finish_video_features,
extract_video_features and its CLI) and the trainer's PhaseTimer."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.data.prefetch import prefetch
from hirest_tpu_torch.extraction import features
from hirest_tpu_torch.extraction.features import finish_video_features
from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
from hirest_tpu_torch.utils import profiling
from hirest_tpu_torch.utils.init import random_eva_vision_state_dict
from hirest_tpu_torch.utils.profiling import PhaseTimer, span, spans

TINY = EvaVisionConfig(image_size=28, layers=2, width=64, head_width=16,
                       mlp_ratio=4.0, patch_size=14, embed_dim=32)
CLOCK_NS = 200_000  # a record lies within its profiler range to 0.2 ms


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(records=None) -> dict:
    out = {}
    for r in spans() if records is None else records:
        out.setdefault(r.name, []).append(r)
    return out


@pytest.fixture(scope="module")
def tiny_apply():
    sd = random_eva_vision_state_dict(TINY, seed=3)
    return build_scanned_vision_apply(sd, TINY, dtype=torch.float32,
                                      attn_v3=True, device="cpu")


def test_off_is_the_shared_null_context_and_records_nothing(tiny_apply):
    assert span("a") is span("b", bytes=3) is profiling._OFF
    with span("a") as s:
        assert s is None
    list(prefetch(range(3)))
    tiny_apply(np.zeros((2, 28, 28, 3), np.float32))
    finish_video_features([torch.ones(2, 4)])
    with PhaseTimer().phase("step"):
        pass
    assert spans() == [] and profiling.current() is None


def test_names_nesting_parents_and_traces():
    with traced():
        with span("outer", video="v1") as outer:
            assert profiling.current() is outer
            with span("inner") as inner:
                inner.attrs["bytes"] = 7
            with span("inner"):
                pass
        with span("second"):
            pass
    assert profiling.current() is None
    got = by_name()
    (o,), (s,) = got["outer"], got["second"]
    assert [r.parent_id for r in got["inner"]] == [o.span_id] * 2
    assert {r.trace_id for r in got["inner"]} == {o.trace_id}
    assert o.parent_id is None and o.trace_id == o.span_id
    assert s.parent_id is None and s.trace_id not in (o.trace_id, None)
    assert o.attrs == {"video": "v1"} and got["inner"][0].attrs == {
        "bytes": 7}
    assert all(o.start_ns <= r.start_ns <= r.end_ns <= o.end_ns
               for r in got["inner"])
    assert len({r.span_id for r in spans()}) == 4
    assert {r.thread for r in spans()} == {threading.get_ident()}


def test_spans_returns_without_clearing():
    with traced():
        with span("a"):
            pass
    first = spans()
    assert [r.name for r in first] == ["a"] and spans() == first
    profiling.clear_spans()
    assert spans() == []


def test_prefetch_produce_shares_the_trace_on_the_producer_thread():
    items = [np.full(3, i) for i in range(4)]
    with traced():
        with span("extract.video") as video:
            got = list(prefetch(iter(items), depth=2))
    assert [int(g[0]) for g in got] == [0, 1, 2, 3]
    rec = by_name()
    (start,) = rec["prefetch.start"]
    assert start.parent_id == video.span_id
    produce = rec["prefetch.produce"]
    assert len(produce) == len(items) + 1  # and the call that ends it
    assert {r.parent_id for r in produce} == {start.span_id}
    assert {r.trace_id for r in produce} == {video.trace_id}
    assert {r.thread for r in produce} != {threading.get_ident()}
    wait = rec["prefetch.wait"]
    assert len(wait) == len(items) + 1
    assert {r.parent_id for r in wait} == {video.span_id}
    assert all(r.attrs == {} for r in wait)


def test_a_prefetch_made_outside_any_span_starts_its_own_trace():
    with traced():
        list(prefetch(range(2)))
        list(prefetch(range(2)))
    starts = by_name()["prefetch.start"]
    assert [r.parent_id for r in starts] == [None, None]
    for st in starts:
        produce = [r for r in spans() if r.name == "prefetch.produce"
                   and r.parent_id == st.span_id]
        assert len(produce) == 3
        assert {r.trace_id for r in produce} == {st.span_id}


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_apply_records_one_copy_and_one_forward_a_call(tiny_apply, dtype):
    imgs = np.zeros((3, 28, 28, 3), np.float32)
    apply = tiny_apply
    if dtype == np.uint8:
        sd = random_eva_vision_state_dict(TINY, seed=3)
        apply = build_scanned_vision_apply(sd, TINY, dtype=torch.float32,
                                           attn_v3=True, uint8_input=True,
                                           device="cpu")
        imgs = imgs.astype(np.uint8)
    with traced():
        for _ in range(2):
            assert apply(imgs).shape == (3, TINY.embed_dim)
    rec = by_name()
    assert [r.attrs for r in rec["eva.copy_in"]] == [
        {"bytes": imgs.nbytes}] * 2
    assert [r.attrs for r in rec["eva.forward"]] == [{}] * 2
    for c, f in zip(rec["eva.copy_in"], rec["eva.forward"]):
        assert c.parent_id is None and c.end_ns <= f.start_ns


@pytest.mark.parametrize("batches", [1, 3])
def test_finish_records_one_fetch_a_batch(batches):
    embs = [torch.randn(5 if i < batches - 1 else 2, 8)
            for i in range(batches)]
    with traced():
        got = finish_video_features(embs, True, 4.6)
    rec = by_name()
    fetch = rec["features.fetch"]
    assert len(fetch) == batches
    assert all(a.end_ns <= b.start_ns for a, b in zip(fetch, fetch[1:]))
    (norm,) = rec["features.normalise"]
    assert norm.start_ns >= fetch[-1].end_ns
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)
    assert len(got) == min(5, sum(len(e) for e in embs))


def test_records_lie_within_their_profiler_ranges(tiny_apply):
    """Each record's [start, end] lies within its own hirest.* range among
    the profiler's events, to 0.2 ms: the program's clock is the trace's."""
    with traced() as prof:
        with span("extract.video"):
            embs = [tiny_apply(b) for b, _ in prefetch(
                (np.zeros((2, 28, 28, 3), np.float32), 2) for _ in range(2))]
            finish_video_features(embs)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(profiling.SPAN_PREFIX):
            events.setdefault(ev.name()[len(profiling.SPAN_PREFIX):],
                              []).append((ev.start_ns(), ev.end_ns()))
    main = [r for r in spans() if r.thread == threading.get_ident()]
    assert {r.name for r in main} == {
        "extract.video", "prefetch.start", "prefetch.wait", "eva.copy_in",
        "eva.forward", "features.fetch", "features.normalise"}
    for name, recs in by_name(main).items():
        ranges = sorted(events[name])
        assert len(ranges) == len(recs)
        for r, (s, e) in zip(sorted(recs, key=lambda r: r.start_ns), ranges):
            assert s - CLOCK_NS <= r.start_ns <= r.end_ns <= e + CLOCK_NS


def test_the_buffer_is_bounded(monkeypatch):
    from collections import deque

    assert profiling._records.maxlen == profiling.MAX_SPANS
    monkeypatch.setattr(profiling, "_records", deque(maxlen=4))
    with traced():
        for i in range(10):
            with span(f"s{i}"):
                pass
    assert [r.name for r in spans()] == ["s6", "s7", "s8", "s9"]


def test_phase_timer_phases_are_spans_and_keep_their_totals():
    timer = PhaseTimer()
    with traced():
        with timer.phase("data"):
            with span("inner"):
                pass
        with timer.phase("data"):
            pass
    with timer.phase("step"):  # no profiler: totals alone
        pass
    rep = timer.report()
    assert rep["data"]["count"] == 2 and rep["step"]["count"] == 1
    rec = by_name()
    assert len(rec["train.data"]) == 2 and "train.step" not in rec
    assert rec["inner"][0].parent_id == rec["train.data"][0].span_id


def _write_frames(root, lengths: dict) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    for vid, n in lengths.items():
        d = root / vid
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                            ).save(d / f"frame_{i:05d}.jpg")


def _encoder(apply):
    def preprocess(img):
        return np.asarray(img.resize((28, 28)), np.float32) / 255.0
    return apply, preprocess


def test_extraction_spans_share_each_videos_trace(tmp_path, tiny_apply):
    _write_frames(tmp_path / "frames", {"v1": 5, "v2": 2})
    enc, pre = _encoder(tiny_apply)
    with traced():
        assert features.extract_video_features(
            str(tmp_path / "frames"), str(tmp_path / "out"), enc, pre,
            batch_size=2) == 2
    rec = by_name()
    videos = {r.attrs["video"]: r for r in rec["extract.video"]}
    assert set(videos) == {"v1", "v2"}
    for vid, batches in (("v1", 3), ("v2", 1)):
        tid = videos[vid].trace_id
        mine = by_name([r for r in spans() if r.trace_id == tid])
        assert len(mine["eva.forward"]) == batches
        assert len(mine["features.fetch"]) == batches
        assert len(mine["prefetch.produce"]) == batches + 1
        (save,) = mine["extract.save"]
        assert save.parent_id == videos[vid].span_id
        assert (tmp_path / "out" / f"{vid}.npy").exists()


def test_the_cli_writes_a_chrome_trace_with_the_spans(tmp_path, monkeypatch,
                                                      tiny_apply):
    _write_frames(tmp_path / "frames", {"v1": 3})
    monkeypatch.setattr(features, "make_eva_encoder",
                        lambda *a, **k: _encoder(tiny_apply))
    assert features.main(["--frame_dir", str(tmp_path / "frames"),
                          "--out_dir", str(tmp_path / "out"),
                          "--batch_size", "2", "--device", "cpu",
                          "--trace_dir", str(tmp_path / "trace")]) == 0
    (path,) = (tmp_path / "trace").glob("*.json")
    names = {ev.get("name") for ev in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"hirest.extract.video", "hirest.eva.forward",
            "hirest.features.fetch", "hirest.extract.save"} <= names
    assert np.load(tmp_path / "out" / "v1.npy").shape == (3, TINY.embed_dim)
