"""The yardstick: published peaks, and the least time at peak of a
product, a fused MLP or an attention, counted from its shapes. What one
system's step runs of them is counted under work/.

Nothing here reads the program. The arithmetic is copied so that a change
to the program cannot move the yardstick:

- `bound` is chip_smoke.py:492-498 (`bound`);
- `int8_gemm_bound` is chip_smoke.py:1886-1894;
- the K4 bound is chip_smoke.py:3404-3405 (`res["K4"]`), the K1 bound
  chip_smoke.py:3369-3376 (`res["K1"]`).

Peaks are NVIDIA's data sheet for one H100 SXM, dense, at its 700 W power
limit: 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s of HBM.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def bound(moved_bytes: float, ops: float, ops_per_s: float) -> float:
    """The least time in seconds the card could take: bytes over the memory
    rate or operations over the peak rate of their type, whichever is
    larger."""
    return max(moved_bytes / HBM_BYTES_PER_S, ops / ops_per_s)


def int8_gemm_bound(m: int, k: int, n: int, out_bytes: int, with_bias: bool,
                    with_res: bool) -> float:
    """G1's least time: 2 M N K int8 operations, or the bytes (x_q, w_q, the
    scales and bias read once, the output written and the residual read at
    out_bytes a value)."""
    moved = (m * k + n * k + m * 4 + n * 4 * (2 if with_bias else 1)
             + m * n * out_bytes * (2 if with_res else 1))
    return bound(moved, 2 * m * n * k, PEAK_OPS_PER_S["int8"])


def fused_mlp_int8_bound(m: int, w: int, hid: int) -> float:
    """K4's least time: fc1 and fc2 in int8, or the bytes (h's codes and
    scales, the residual read and written in bf16, both weights' codes, the
    scales and biases)."""
    return bound(m * w + m * 4 + 2 * m * w * 2 + 2 * hid * w
                 + 4 * (2 * hid + 2 * w), 2 * 2 * m * w * hid,
                 PEAK_OPS_PER_S["int8"])


def bf16_gemm_bound(m: int, k: int, n: int) -> float:
    """A bf16 product's least time: 2 M N K at the bf16 peak, or both
    operands read and the output written once."""
    return bound((m * k + k * n + m * n) * 2, 2 * m * n * k,
                 PEAK_OPS_PER_S["bf16"])


def attention_bound(batch: int, tokens: int, inner: int) -> float:
    """K1's least time on one layer of `batch` sequences of `tokens`, heads
    `inner` wide in all: qkv read and the output written in bf16, or QK^T
    and PV at the bf16 peak."""
    m = batch * tokens
    return bound(m * 3 * inner * 2 + m * inner * 2,
                 4 * batch * tokens * tokens * inner,
                 PEAK_OPS_PER_S["bf16"])
