"""The work of the EVA vision tower's forward, counted from the
configuration's sizes (image_size, patch_size, layers, width, head_width,
mlp_ratio, embed_dim) and the traffic's batch.

`useful_ops_per_frame` splits hirest_tpu_torch/bench.py:183-200
(`eva_useful_tflops_per_frame`, 0.534063 TFLOP a frame at EVA-g's widths)
by product, so that each runs at the peak of the precision the
configuration's `int8_products` says it runs in.
"""

from __future__ import annotations

from portbench import yardstick

PEAK = yardstick.PEAK_OPS_PER_S


def tokens(cfg: dict) -> int:
    """Tokens a frame: the patches and the class token."""
    return (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1


def mlp_hidden(cfg: dict) -> int:
    return int(cfg["width"] * cfg["mlp_ratio"])


def inner(cfg: dict) -> int:
    """The attention's width: heads times head width."""
    return (cfg["width"] // cfg["head_width"]) * cfg["head_width"]


def useful_ops_per_frame(cfg: dict) -> dict:
    """Operations (2 M N K) a frame needs, by product name: the four
    projections of every layer, the attention's two products, the patch
    embedding and the head, at the logical widths (no padding)."""
    n, w, hid, i = tokens(cfg), cfg["width"], mlp_hidden(cfg), inner(cfg)
    layers = cfg["layers"]
    return {
        "qkv": layers * n * 2 * w * 3 * i,
        "out": layers * n * 2 * i * w,
        "fc1": layers * n * 2 * w * hid,
        "fc2": layers * n * 2 * hid * w,
        "attention": layers * n * 4 * n * i,
        "patch": (n - 1) * 2 * cfg["patch_size"] ** 2 * 3 * w,
        "head": 2 * w * cfg["embed_dim"],
    }


def frame_seconds_at_peak(cfg: dict) -> float:
    """The least time a frame's useful operations take at peak, each product
    at the peak of the precision the configuration runs it in."""
    int8 = set(cfg.get("int8_products", ()))
    return sum(ops / PEAK["int8" if name in int8 else "bf16"]
               for name, ops in useful_ops_per_frame(cfg).items())


def useful(cfg: dict, traffic: dict, window) -> float:
    """The real frames the window finished, at their least time a frame:
    padding slots count for nothing."""
    return sum(r.n for r in window.requests) * frame_seconds_at_peak(cfg)


def _per_forward(window, layer_seconds: float, cfg: dict) -> float:
    return window.steps * cfg["layers"] * layer_seconds


def g1_qkv_out(cfg: dict, traffic: dict, window) -> float:
    """G1's products in every forward the window ran: qkv with its bias and
    the out projection with its bias and residual, bf16 out, at M = batch x
    tokens rows."""
    m, w, i = traffic["batch"] * tokens(cfg), cfg["width"], inner(cfg)
    return _per_forward(window, yardstick.int8_gemm_bound(
        m, w, 3 * i, 2, True, False) + yardstick.int8_gemm_bound(
        m, i, w, 2, True, True), cfg)


def k4_mlp(cfg: dict, traffic: dict, window) -> float:
    """K4's fc1, activation and fc2 in every forward the window ran."""
    m = traffic["batch"] * tokens(cfg)
    return _per_forward(window, yardstick.fused_mlp_int8_bound(
        m, cfg["width"], mlp_hidden(cfg)), cfg)


def bf16_products(cfg: dict, traffic: dict, window) -> float:
    """Every bf16 product of the forwards the window ran: qkv, out, fc1 and
    fc2 of each layer, the patch embedding and the head."""
    b, n = traffic["batch"], tokens(cfg)
    m, w, hid, i = b * n, cfg["width"], mlp_hidden(cfg), inner(cfg)
    g = yardstick.bf16_gemm_bound
    layer = g(m, w, 3 * i) + g(m, i, w) + g(m, w, hid) + g(m, hid, w)
    once = (g(b * (n - 1), cfg["patch_size"] ** 2 * 3, w)
            + g(b, w, cfg["embed_dim"]))
    return _per_forward(window, layer, cfg) + window.steps * once


def k1_attention(cfg: dict, traffic: dict, window) -> float:
    """K1's attention in every layer of the forwards the window ran."""
    return _per_forward(window, yardstick.attention_bound(
        traffic["batch"], tokens(cfg), inner(cfg)), cfg)
