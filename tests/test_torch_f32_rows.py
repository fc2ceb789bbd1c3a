"""The f32 forms of the row kernels K5 (act_quant) and K10 (ln_bf16), the
f32 int8 paths' and the f32 fused-LayerNorm path's inputs, on the CPU.

On the card an f32 tensor in `act_quant` launches act_quant.cu's
act_quant_f32_kernel and one in `ln_bf16` ln_quant.cu's ln_f32_kernel; here
the wrappers take their plain versions. The kernels' arithmetic is
emulated in PyTorch and held against the plain versions and against the
JAX Pallas kernels (interpret mode) on f32 rows at EVA-g's widths, at the
card's bars (chip_smoke.py's row_checks):
- K5: codes within one of the reference and equal on 99.9 % of them,
  scales within 1e-6 relative;
- K10: within 1e-5 of each row's largest |value| (F32_TOL): the kernel
  sums a row in another order than the references, and its rsqrtf is not
  correctly rounded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_util import assert_codes_close

from hirest_tpu.ops.quant import act_quant as jax_act_quant
from hirest_tpu.ops.quant import ln_bf16 as jax_ln_bf16
from hirest_tpu_torch.ops import quant
from hirest_tpu_torch.ops.quant import (QUANT_ACTS, _act, act_quant,
                                        act_quant_ref, ln_bf16, ln_bf16_ref,
                                        ln_quant, row_kernel_shape)

C, HIDDEN, EPS = 1408, 6144, 1e-6  # EVA-g's trunk and MLP widths
F32_TOL = 1e-5
ROWS = [1, 13, 257]  # one row; not a multiple of a block's rows; a frame


def _lanes(x, group: int):
    """[M, C] -> [M, K, group, 4]: thread t of a row's group holds the
    row's 4-value vectors t, t + group, ... as [:, k, t] (zero-padded to
    whole strides), and a mask [1, K, group, 1] of the vectors that
    exist."""
    m, c = x.shape
    nv = c // 4
    k = -(-nv // group)
    v = F.pad(x, (0, k * group * 4 - c)).view(m, k, group, 4)
    valid = (torch.arange(k * group).view(1, k, group, 1) < nv)
    return v, valid


def _warp_sum(vals):
    """ln_f32_kernel's sum of a row: each lane adds its values in turn
    (vector by vector, each vector's four in order), then warp_sum's xor
    butterfly over the 32 lanes. vals [M, K, 32, 4] -> [M, 1]."""
    acc = torch.zeros(vals.shape[0], 32)
    for k in range(vals.shape[1]):
        for e in range(4):
            acc = acc + vals[:, k, :, e]
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, torch.arange(32) ^ off]
    return acc[:, :1]


def _ln_f32_kernel(x, g, b, eps: float):
    """ln_f32_kernel (K10's f32 form), step by step in f32: a warp a row,
    the mean and the centred sum of squares each by _warp_sum and a true
    division by C, r = rsqrt(var + eps), then (xc r) g + b, each product
    and sum rounded on its own."""
    m, c = x.shape
    v, valid = _lanes(x, 32)
    cf = torch.tensor(float(c))
    mu = _warp_sum(v) / cf
    xc = v - mu[..., None, None]
    r = torch.rsqrt(_warp_sum(torch.where(valid, xc * xc, 0.0)) / cf + eps)
    gl, bl = (_lanes(t.view(1, c), 32)[0] for t in (g, b))
    y = (xc * r[..., None, None]) * gl + bl
    return y.reshape(m, -1)[:, :c]


def _act_quant_f32_kernel(x, act: str):
    """act_quant_f32_kernel (K5's f32 form): a warp a row up to 2048 wide,
    else a warpgroup; each thread's max |act(x)| over its vectors, then the
    warp's, then the warpgroup's; s = max(amax / 127, 1e-8) and y / s as
    IEEE divisions, rounded half to even and clipped to +-127."""
    m, c = x.shape
    group = 32 if c <= 2048 else 128
    y = _act(act, QUANT_ACTS)(x)
    v, _ = _lanes(y, group)
    per_thread = v.abs().amax((1, 3))
    amax = per_thread.view(m, group // 32, 32).amax(-1).amax(-1, keepdim=True)
    s = (amax / torch.tensor(127.0)).clamp_min(1e-8)
    return torch.round(y / s).clamp(-127, 127).to(torch.int8), s


def _rows(seed: int, m: int, c: int, ln: bool = False):
    """f32 [m, c] rows of order one with a per-row spread (and, for a
    LayerNorm, a per-row offset), a row of zeros at 5 % m where m > 1;
    for K5 without activation at c = 1408 and m > 2, rows 0 and 1 hold
    +-127 (scale 1) with every other value on k + 1/2, which must round to
    even."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, c)) * rng.uniform(0.5, 3, (m, 1))
    if ln:
        x += rng.normal(size=(m, 1))
    if m > 1:
        x[5 % m] = 0.0
    if not ln and c == C and m > 2:
        halves = np.arange(c - 1) % 254 - 126.5
        x[0, 0], x[0, 1:] = 127.0, halves
        x[1, 0], x[1, 1:] = -127.0, -halves[::-1]
    return torch.from_numpy(x.astype(np.float32))


K5_CASES = [(HIDDEN, "gelu_poly"), (HIDDEN, "gelu"), (HIDDEN, "none"),
            (C, "none")]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("c,act", K5_CASES,
                         ids=[f"{c}-{a}" for c, a in K5_CASES])
def test_act_quant_f32_kernel_arithmetic(c, act, m):
    """K5's f32 form, emulated, against the plain version and the JAX
    kernel in interpret mode on the same f32 rows, at the card's bars; a
    row of zeros gives scale 1e-8 and codes 0, and k + 1/2 quotients round
    to even."""
    x = _rows(100 + m + c, m, c)
    got = _act_quant_f32_kernel(x, act)
    plain = act_quant(x, act=act)
    jq, js = jax_act_quant(jnp.asarray(x.numpy()), act=act, interpret=True)
    for q, s in (plain, (torch.from_numpy(np.array(jq)),
                         torch.from_numpy(np.array(js)))):
        assert q.shape == (m, c) and s.shape == (m, 1)
        np.testing.assert_allclose(got[1].numpy(), s.numpy(), rtol=1e-6)
        assert_codes_close(got[0].numpy(), q.numpy(), 0.999)
    if m > 1:
        assert got[1][5].item() == np.float32(1e-8) and not got[0][5].any()
    if act == "none" and c == C and m > 2:
        ties = np.round(x[:2, 1:].numpy()).astype(np.int8)
        np.testing.assert_array_equal(got[0][:2, 1:].numpy(), ties)
        np.testing.assert_array_equal(plain[0][:2].numpy(),
                                      got[0][:2].numpy())


@pytest.mark.parametrize("m", ROWS)
def test_ln_f32_kernel_arithmetic(m):
    """K10's f32 form, emulated, against the plain version and the JAX
    kernel in interpret mode on the same f32 rows [m, 1408]: within 1e-5
    of each row's largest |value|, f32 out; a row of zeros gives b."""
    x = _rows(200 + m, m, C, ln=True)
    rng = np.random.default_rng(300 + m)
    g = torch.from_numpy((1 + 0.02 * rng.normal(size=C)).astype(np.float32))
    b = torch.from_numpy((0.02 * rng.normal(size=C)).astype(np.float32))
    got = _ln_f32_kernel(x, g, b, EPS)
    plain = ln_bf16(x, g, b, EPS)
    want = jax_ln_bf16(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
                       jnp.asarray(b.numpy()), EPS, interpret=True)
    assert want.dtype == jnp.float32 and plain.dtype == torch.float32
    for ref in (plain.numpy(), np.asarray(want)):
        top = np.abs(ref).max(-1, keepdims=True)
        assert np.all(np.abs(got.numpy() - ref) <= F32_TOL * top)
    if m > 1:
        np.testing.assert_allclose(got[5].numpy(), b.numpy(), rtol=0,
                                   atol=1e-7)


def test_f32_row_calls_on_the_cpu_count_nothing():
    """On the CPU the f32 calls of the three row wrappers take their plain
    versions and count no launch, bf16 or f32."""
    wrappers = (act_quant, ln_bf16, ln_quant)
    before = [(w.launches, w.launches_f32) for w in wrappers]
    x = _rows(400, 13, C, ln=True)
    g, b = torch.ones(C), torch.zeros(C)
    for act in QUANT_ACTS:
        got, want = act_quant(x, act=act), act_quant_ref(x, act=act)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert torch.equal(ln_bf16(x, g, b, EPS), ln_bf16_ref(x, g, b, EPS))
    ln_quant(x, g, b, EPS)
    assert [(w.launches, w.launches_f32) for w in wrappers] == before


def test_row_kernel_shape_takes_the_f32_forms():
    """The row kernels' input check, which the CUDA wrappers call: f32 rows
    of EVA-g's widths pass for all three, as bf16 ones do; another dtype,
    a non-contiguous or misaligned tensor, or a C off the form's multiple
    or past its widest raise."""
    for what, c in (("act_quant", HIDDEN), ("act_quant", C), ("ln_bf16", C),
                    ("ln_quant", C)):
        for dtype in (torch.float32, torch.bfloat16):
            assert row_kernel_shape(what, dtype, (2, 257, c)) == (514, c)
    with pytest.raises(TypeError):
        row_kernel_shape("act_quant", torch.float16, (4, HIDDEN))
    with pytest.raises(TypeError):
        row_kernel_shape("ln_bf16", torch.float32, (4, C), contiguous=False)
    with pytest.raises(TypeError):
        row_kernel_shape("ln_quant", torch.float32, (4, C), aligned=False)
    with pytest.raises(TypeError):
        row_kernel_shape("act_quant", torch.float32, (C,))
    with pytest.raises(ValueError, match="C % 4"):
        row_kernel_shape("act_quant", torch.float32, (4, 1406))
    with pytest.raises(ValueError, match="C % 16"):
        row_kernel_shape("act_quant", torch.bfloat16, (4, 1400))
    with pytest.raises(ValueError, match="8192"):
        row_kernel_shape("act_quant", torch.float32, (4, 8196))
    with pytest.raises(ValueError, match="2048"):
        row_kernel_shape("ln_bf16", torch.float32, (4, 2052))
    assert set(quant.ROW_KERNELS) == {"act_quant", "ln_bf16", "ln_quant"}
