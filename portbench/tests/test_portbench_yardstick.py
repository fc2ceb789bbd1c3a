"""The copied bound arithmetic reproduces PERF.md's numbers, and mfu takes
each product at the peak of the precision it runs in."""

import pytest

from portbench import registry, trace, yardstick
from portbench.readers import mfu
from portbench.records import Record, Window
from portbench.systems.eva_extract import Video
from portbench.work import eva_vision

M = 128 * 257  # rows of a B=128 forward
B128 = {"batch": 128}


def _cfg(name):
    return registry.cell(name, registry.benchmark()).config


def test_bounds_reproduce_perf_md():
    assert yardstick.int8_gemm_bound(M, 1408, 4224, 2, True, False) * 1e3 \
        == pytest.approx(0.1977, abs=5e-5)
    assert yardstick.fused_mlp_int8_bound(M, 1408, 6144) * 1e3 \
        == pytest.approx(0.5752, abs=5e-5)
    assert yardstick.attention_bound(128, 257, 1408) * 1e3 == pytest.approx(
        0.1106, abs=5e-5)


def test_work_of_a_window_counts_every_forward():
    cfg = _cfg("eva-clip-g14-bf16.corpus")
    one, five = Window(0.0, 1.0, [], 1), Window(0.0, 1.0, [], 5)
    assert eva_vision.k4_mlp(cfg, B128, one) == pytest.approx(
        40 * yardstick.fused_mlp_int8_bound(M, 1408, 6144))
    assert eva_vision.k1_attention(cfg, B128, one) == pytest.approx(
        40 * yardstick.attention_bound(128, 257, 1408))
    assert eva_vision.g1_qkv_out(cfg, B128, one) > 40 * 0.1977e-3
    for work in (eva_vision.k4_mlp, eva_vision.k1_attention,
                 eva_vision.g1_qkv_out, eva_vision.bf16_products):
        assert work(cfg, B128, five) == pytest.approx(
            5 * work(cfg, B128, one))


def test_useful_operations_are_bench_py_s():
    ops = eva_vision.useful_ops_per_frame(_cfg("eva-clip-g14-int8.corpus"))
    assert sum(ops.values()) / 1e12 == pytest.approx(0.534063, abs=5e-7)


def test_mfu_takes_int8_products_at_the_int8_peak():
    i8 = _cfg("eva-clip-g14-int8.corpus")
    b16 = _cfg("eva-clip-g14-bf16.corpus")
    ops = eva_vision.useful_ops_per_frame(i8)
    int8 = sum(ops[k] for k in ("qkv", "out", "fc1", "fc2"))
    rest = sum(ops.values()) - int8
    assert eva_vision.frame_seconds_at_peak(i8) == pytest.approx(
        int8 / 1979e12 + rest / 989e12)
    assert eva_vision.frame_seconds_at_peak(b16) == pytest.approx(
        sum(ops.values()) / 989e12)
    # a window exactly as long as its frames take at peak reads 100 %
    frames = 1000
    t = frames * eva_vision.frame_seconds_at_peak(i8)
    rec = Record(i8, B128, 1.0, Window(0.0, t, [Video(frames, t)], 8),
                 trace.Timeline((0, round(t * 1e9)), ops=[(0, 1, "k")]))
    assert mfu.read({"work": "eva_vision.useful"}, rec) == pytest.approx(
        100.0, rel=1e-6)
