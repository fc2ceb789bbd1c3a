"""The port's int8 pieces (hirest_tpu_torch/ops/quant.py) against the JAX
package's: weight quantization, row quantization and the int8 products of
eva_scan, and the plain versions of K2 (ln_quant), K4 (fused_mlp_int8), K5
(act_quant) and K10 (ln_bf16) against the Pallas kernels in interpret
mode, at EVA-g's real widths.

On the CPU the port's wrappers take their plain versions, so these tests
hold the plain versions' arithmetic against the TPU kernels'; the CUDA
kernels are held against the plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import assert_codes_close

from hirest_tpu.models.eva_scan import _dyn_quant_rows as jax_dyn_quant_rows
from hirest_tpu.models.eva_scan import _int8_mm as jax_int8_mm
from hirest_tpu.models.eva_scan import \
    _quantize_stacked as jax_quantize_stacked
from hirest_tpu.models.eva_scan import _ln as jax_ln
from hirest_tpu.ops.quant import act_quant as jax_act_quant
from hirest_tpu.ops.quant import fused_mlp_int8 as jax_fused_mlp
from hirest_tpu.ops.quant import ln_bf16 as jax_ln_bf16
from hirest_tpu.ops.quant import ln_quant as jax_ln_quant
from hirest_tpu.ops.quant import quantize_weight as jax_quantize_weight
from hirest_tpu_torch.models.layers import gelu_bf16_poly
from hirest_tpu_torch.ops.quant import (act_quant, act_quant_ref,
                                        dyn_quant_rows, fused_mlp_int8,
                                        fused_mlp_int8_ref, int8_mm,
                                        ln_bf16, ln_bf16_ref, ln_quant,
                                        ln_quant_ref, mlp_int8_hidden_ref,
                                        mlp_int8_out_ref, quantize_weight)

C, F, EPS = 1408, 6144, 1e-6  # EVA-g trunk width, MLP width, LayerNorm eps


def _rng(seed):
    return np.random.default_rng(seed)


def _weight_with_ties(rng, shape):
    """f32 weights whose every column has max |w| = 127, so its scale is 1
    and w / scale lands on exact halves, plus an all-zero column."""
    w = rng.normal(size=shape).astype(np.float32) * 20
    w[..., 0, :] = 127.0
    w[..., 1, :3] = [2.5, -3.5, 0.5]
    w[..., -1] = 0.0
    return w


def test_quantize_weight_is_bit_equal_to_jax():
    """Per (layer, output channel) codes and scales: half-even rounding of
    exact ties, the 1e-8 scale floor of an all-zero channel."""
    w = _weight_with_ties(_rng(0), (3, 96, 40))  # [L, in, out] as JAX has it
    jq, js = jax_quantize_stacked(w)
    q, s = quantize_weight(torch.from_numpy(w).transpose(1, 2))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.transpose(1, 2).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, 1] == 2 and q[0, 1, 1] == -4 and q[0, 2, 1] == 0
    jq2, js2 = jax_quantize_weight(w[0])
    q2, s2 = quantize_weight(torch.from_numpy(w[0]).T)
    np.testing.assert_array_equal(q2.T.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))


def test_dyn_quant_rows_is_bit_equal_to_jax():
    x = _rng(1).normal(size=(37, 256)).astype(np.float32)
    x[3] = 0.0
    jq, js = jax_dyn_quant_rows(jnp.asarray(x))
    q, s = dyn_quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_mm_matches_jax(with_bias):
    """The int32 product is exact in both; the f32 epilogue
    (acc * x_s) * w_s + bias agrees to an f32 rounding."""
    rng = _rng(2)
    x_q = rng.integers(-127, 128, (300, C), dtype=np.int8)
    x_s = rng.uniform(0.01, 0.05, (300, 1)).astype(np.float32)
    w_q = rng.integers(-127, 128, (C, 512), dtype=np.int8)  # [in, out]
    w_s = rng.uniform(1e-4, 1e-3, 512).astype(np.float32)
    bias = rng.normal(size=512).astype(np.float32) if with_bias else None
    want = np.asarray(jax_int8_mm(
        jnp.asarray(x_q), jnp.asarray(x_s), jnp.asarray(w_q),
        jnp.asarray(w_s), None if bias is None else jnp.asarray(bias),
        jnp.float32))
    got = int8_mm(torch.from_numpy(x_q), torch.from_numpy(x_s),
                  torch.from_numpy(w_q.T.copy()), torch.from_numpy(w_s),
                  None if bias is None else torch.from_numpy(bias),
                  torch.float32)
    assert got.dtype == torch.float32 and got.shape == (300, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --- K2 ln_quant ----------------------------------------------------------


def _ln_inputs(seed, m):
    rng = _rng(seed)
    # a residual stream with a per-row offset and spread, as the trunk has
    x = (rng.normal(size=(m, C)) * rng.uniform(0.5, 3, (m, 1))
         + rng.normal(size=(m, 1))).astype(np.float32)
    g = (1 + 0.02 * rng.normal(size=C)).astype(np.float32)
    b = (0.02 * rng.normal(size=C)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_quant_plain_matches_jax(dtype):
    """[2*257, 1408]: scales within rtol 1e-6, codes within one and equal on
    99.9 %: the two LayerNorms reduce in another order, and a code at a
    rounding boundary may go either way."""
    x, g, b = _ln_inputs(3, 2 * 257)
    xt = torch.from_numpy(x).to(dtype)
    jq, js = jax_ln_quant(jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(g), jnp.asarray(b), EPS, interpret=True, row_block=257)
    q, s = ln_quant(xt, torch.from_numpy(g), torch.from_numpy(b), EPS)
    assert q.dtype == torch.int8 and q.shape == (2 * 257, C)
    assert s.dtype == torch.float32 and s.shape == (2 * 257, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert_codes_close(q.numpy(), np.asarray(jq), 0.999)


def test_ln_quant_keeps_the_layernorm_in_f32():
    """The LayerNorm output goes into the quantization unrounded: its codes
    are those of the f32 LayerNorm, not of the LayerNorm rounded to bf16."""
    x, g, b = _ln_inputs(4, 64)
    xt = torch.from_numpy(x).bfloat16()
    y = torch.nn.functional.layer_norm(xt.float(), (C,), torch.from_numpy(g),
                                       torch.from_numpy(b), EPS)
    q, _ = ln_quant_ref(xt, torch.from_numpy(g), torch.from_numpy(b), EPS)
    assert_codes_close(q.numpy(), dyn_quant_rows(y)[0].numpy(), 0.999)
    rounded = dyn_quant_rows(y.bfloat16())[0]
    assert not torch.equal(q, rounded)


# --- K10 ln_bf16 -----------------------------------------------------------


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_bf16_plain_matches_jax(dtype):
    """[2*257, 1408] against the Pallas kernel: f32 within 1e-6 (the two
    reduce in another order), bf16 within one bf16 ulp of each output plus
    that 1e-6 (an f32 difference that straddles a rounding boundary, which
    near zero is finer than 1e-6); the output keeps the input dtype."""
    x, g, b = _ln_inputs(15, 2 * 257)
    xt = torch.from_numpy(x).to(dtype)
    want = np.asarray(jax_ln_bf16(
        jnp.asarray(xt.float().numpy()).astype(_jax_dtype(dtype)),
        jnp.asarray(g), jnp.asarray(b), EPS, interpret=True,
        row_block=257).astype(jnp.float32))
    got = ln_bf16(xt, torch.from_numpy(g), torch.from_numpy(b), EPS)
    assert got.dtype == dtype and got.shape == (2 * 257, C)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert np.all(np.abs(got.float().numpy() - want) <= ulp + 1e-6)


def test_ln_bf16_is_eva_scan_ln():
    """K10's plain version is eva_scan._ln, on a [B, S, C] trunk: f32
    within 1e-6."""
    x, g, b = _ln_inputs(16, 3 * 40)
    x3 = x.reshape(3, 40, C)
    want = np.asarray(jax_ln(jnp.asarray(x3), jnp.asarray(g), jnp.asarray(b),
                             EPS))
    got = ln_bf16_ref(torch.from_numpy(x3), torch.from_numpy(g),
                      torch.from_numpy(b), EPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --- K5 act_quant -----------------------------------------------------------


def _fc1_output(seed, m, c=F):
    """What the int8 MLP hands act_quant: an fc1 output of order one, with
    a per-row spread."""
    rng = _rng(seed)
    return (rng.normal(size=(m, c)) * rng.uniform(0.5, 3, (m, 1))
            ).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["gelu_poly", "gelu", "none"])
def test_act_quant_plain_matches_jax(act, dtype):
    """[2*257, 6144] (the fc1 output of EVA-g's MLP) against the Pallas
    kernel, at K2's bars: scales within rtol 1e-6, codes within one and
    equal on 99.9 % (exact GELU's erf may round differently by an ulp,
    which can move a code at a rounding boundary)."""
    x = _fc1_output(17, 2 * 257)
    xt = torch.from_numpy(x).to(dtype)
    jq, js = jax_act_quant(jnp.asarray(xt.float().numpy()).astype(
        _jax_dtype(dtype)), act=act, interpret=True, row_block=257)
    q, s = act_quant(xt, act=act)
    assert q.dtype == torch.int8 and q.shape == (2 * 257, F)
    assert s.dtype == torch.float32 and s.shape == (2 * 257, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert_codes_close(q.numpy(), np.asarray(jq), 0.999)


def test_act_quant_keeps_leading_dims_and_rejects_bad_act():
    """A [B, S, C] attention output quantizes row by row as its [B*S, C]
    view does, with scales [B, S, 1]; an unknown activation raises."""
    x = torch.from_numpy(_fc1_output(18, 6 * 16, c=128)).view(6, 16, 128)
    q, s = act_quant(x)
    q2, s2 = act_quant(x.view(96, 128))
    assert q.shape == (6, 16, 128) and s.shape == (6, 16, 1)
    assert torch.equal(q.view(96, 128), q2) and torch.equal(s.view(96, 1), s2)
    assert torch.equal(q, dyn_quant_rows(x)[0])
    with pytest.raises(ValueError, match="act must be"):
        act_quant(x, act="relu")


def test_act_quant_and_ln_bf16_cpu_calls_count_nothing():
    x = torch.from_numpy(_fc1_output(19, 8, c=C)).bfloat16()
    g, b = torch.ones(C), torch.zeros(C)
    before = (act_quant.launches, ln_bf16.launches)
    for act in ("gelu_poly", "gelu", "none"):
        got, want = act_quant(x, act=act), act_quant_ref(x, act=act)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert torch.equal(ln_bf16(x, g, b, EPS), ln_bf16_ref(x, g, b, EPS))
    assert (act_quant.launches, ln_bf16.launches) == before
    meta = torch.empty((4, C), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        act_quant(meta)
    with pytest.raises(ValueError, match="no kernel"):
        ln_bf16(meta, g, b, EPS)


# --- K2, K5, K10 at the row kernels' edges -----------------------------------


EDGE_KERNELS = {  # case -> its row width
    "ln_quant": C, "ln_bf16": C, "gelu_poly": F, "gelu": F, "none": C}


def _edge_rows(kernel, m):
    """[m, width] bf16-exact f32 rows for an edge case: random rows and,
    where m > 1, a row of zeros (row 5 % m); for act "none", rows 0 and 1
    hold +-127 (scale 1) and every other value on k + 1/2, which must round
    to even."""
    c = EDGE_KERNELS[kernel]
    x = (_ln_inputs(40 + m, m)[0] if kernel.startswith("ln")
         else _fc1_output(41 + m, m, c=c))
    if m > 1:
        x[5 % m] = 0.0
    if kernel == "none" and m > 2:
        halves = np.arange(c - 1) % 254 - 126.5
        x[0, 0], x[0, 1:] = 127.0, halves
        x[1, 0], x[1, 1:] = -127.0, -halves[::-1]
    return torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("m", [1, 13])  # one row; not a multiple of 8
@pytest.mark.parametrize("kernel", list(EDGE_KERNELS))
def test_row_kernels_plain_match_jax_at_edges(kernel, m):
    """The plain K2, K5 and K10 against the Pallas kernels in interpret mode
    at M = 1 and 13 rows, with a row of zeros (K5: scale 1e-8 and codes 0)
    and, for K5 without activation, rows whose quotients land on k + 1/2:
    those codes equal JAX's and half-even rounding exactly. Bars as at the
    main widths."""
    _, g, b = _ln_inputs(43, 1)
    xt = _edge_rows(kernel, m)
    jx = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    if kernel == "ln_bf16":
        want = np.asarray(jax_ln_bf16(jx, jnp.asarray(g), jnp.asarray(b), EPS,
                                      interpret=True).astype(jnp.float32))
        got = ln_bf16(xt, torch.from_numpy(g), torch.from_numpy(b), EPS)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert got.shape == (m, C)
        assert np.all(np.abs(got.float().numpy() - want) <= ulp + 1e-6)
        return
    if kernel == "ln_quant":
        jq, js = jax_ln_quant(jx, jnp.asarray(g), jnp.asarray(b), EPS,
                              interpret=True)
        q, s = ln_quant(xt, torch.from_numpy(g), torch.from_numpy(b), EPS)
    else:
        jq, js = jax_act_quant(jx, act=kernel, interpret=True)
        q, s = act_quant(xt, act=kernel)
    assert q.shape == xt.shape and s.shape == (m, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert_codes_close(q.numpy(), np.asarray(jq), 0.999)
    if m > 1 and kernel != "ln_quant":  # LN(0) = b, coded as any row
        assert s[5].item() == np.float32(1e-8) and not q[5].any()
    if kernel == "none" and m > 2:
        ties = np.round(xt[:2, 1:].float().numpy()).astype(np.int8)
        np.testing.assert_array_equal(q[:2].numpy(), np.asarray(jq)[:2])
        np.testing.assert_array_equal(q[:2, 1:].numpy(), ties)


# --- K4 fused_mlp_int8 ----------------------------------------------------


def _mlp_inputs(seed, m, f=F):
    """What the trunk hands the MLP: ln_quant codes of a LayerNorm output,
    weights quantized from 0.02-scale floats, an f32 residual."""
    rng = _rng(seed)
    h_q, h_s = dyn_quant_rows(torch.from_numpy(
        rng.normal(size=(m, C)).astype(np.float32)))
    w1_q, w1_s = quantize_weight(torch.from_numpy(
        (0.02 * rng.normal(size=(f, C))).astype(np.float32)))
    w2_q, w2_s = quantize_weight(torch.from_numpy(
        (0.02 * rng.normal(size=(C, f))).astype(np.float32)))
    b1 = torch.from_numpy((0.02 * rng.normal(size=f)).astype(np.float32))
    b2 = torch.from_numpy((0.02 * rng.normal(size=C)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, C)).astype(np.float32))
    return h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x


def _jax_mlp(args, act):
    h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x = args
    return np.asarray(jax_fused_mlp(
        jnp.asarray(h_q.numpy()), jnp.asarray(h_s.numpy()),
        jnp.asarray(w1_q.T.numpy()), jnp.asarray(w1_s.numpy()),
        jnp.asarray(b1.numpy()), jnp.asarray(w2_q.T.numpy()),
        jnp.asarray(w2_s.numpy()), jnp.asarray(b2.numpy()),
        jnp.asarray(x.numpy()), act=act, interpret=True))


@pytest.mark.parametrize("act", ["gelu_poly", "gelu"])
def test_fused_mlp_plain_matches_jax(act):
    """[264, 1408] x 6144 (six 1024-unit requant chunks), f32 residual:
    within 1e-3 of the MLP's largest contribution max|want - x|. A hidden
    code that flips between the two moves a row by far less."""
    args = _mlp_inputs(5, 264)
    x = args[-1]
    want = _jax_mlp(args, act)
    got = fused_mlp_int8(*args, act=act)
    assert got.dtype == torch.float32 and got.shape == (264, C)
    scale = np.abs(want - x.numpy()).max()
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * scale)


@pytest.mark.parametrize("f", [2048, 3072])
@pytest.mark.parametrize("act", ["gelu_poly", "gelu"])
def test_split_plain_mlp_matches_jax(f, act):
    """The plain versions of K4's two kernels, composed, against the JAX
    kernel in interpret mode at two and three 1024-unit chunks, at
    test_fused_mlp_plain_matches_jax's bar. Not bit for bit: XLA's CPU
    backend always fuses a multiply feeding an add into one FMA (the
    dequantization, the polynomial, each chunk's accumulation), where the
    plain version and the CUDA kernels round both, as PyTorch's eager
    operations do; a hidden code at a rounding boundary may then land on
    the other side."""
    args = _mlp_inputs(11, 264, f=f)
    h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x = args
    want = _jax_mlp(args, act)
    codes, scales = mlp_int8_hidden_ref(h_q, h_s, w1_q, w1_s, b1, act=act)
    got = mlp_int8_out_ref(codes, scales, w2_q, w2_s, b2, x)
    assert got.dtype == torch.float32 and got.shape == (264, C)
    scale = np.abs(want - x.numpy()).max()
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * scale)


@pytest.mark.parametrize("f", [2048, 3072])
def test_hidden_codes_and_scales_per_chunk(f):
    """mlp_int8_hidden_ref's scales are [M, F / 1024], column j the scale
    of chunk j, and its codes chunk j's codes: the row quantization of the
    activated fc1 output, computed here over all F at once and cut into
    chunks afterwards."""
    h_q, h_s, w1_q, w1_s, b1 = _mlp_inputs(12, 40, f=f)[:5]
    codes, scales = mlp_int8_hidden_ref(h_q, h_s, w1_q, w1_s, b1)
    assert codes.dtype == torch.int8 and codes.shape == (40, f)
    assert scales.dtype == torch.float32 and scales.shape == (40, f // 1024)
    y = torch._int_mm(h_q, w1_q.t()).float().mul_(h_s).mul_(w1_s).add_(b1)
    y = gelu_bf16_poly(y)
    for j in range(f // 1024):
        q, s = dyn_quant_rows(y[:, 1024 * j:1024 * (j + 1)])
        assert torch.equal(scales[:, j:j + 1], s)
        assert torch.equal(codes[:, 1024 * j:1024 * (j + 1)], q)
    assert not torch.equal(scales[:, :1], scales[:, 1:2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_ref_on_hidden_codes_is_the_one_loop_mlp(dtype):
    """mlp_int8_out_ref on mlp_int8_hidden_ref's codes reproduces, bit for
    bit, the MLP computed chunk by chunk in one loop (what
    fused_mlp_int8_ref computed before K4 was split at the codes): the
    split moves no rounding."""
    args = list(_mlp_inputs(13, 40, f=2048))
    args[-1] = args[-1].to(dtype)
    h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x = args
    acc = None
    for j in range(0, 2048, 1024):
        y = torch._int_mm(h_q, w1_q[j:j + 1024].t()).float()
        y.mul_(h_s).mul_(w1_s[j:j + 1024]).add_(b1[j:j + 1024])
        q2, sc = dyn_quant_rows(gelu_bf16_poly(y))
        part = torch._int_mm(q2, w2_q[:, j:j + 1024].t()).float().mul_(sc)
        part.mul_(w2_s)
        acc = (x.float() + b2).add_(part) if acc is None else acc.add_(part)
    want = acc.to(dtype)
    codes, scales = mlp_int8_hidden_ref(h_q, h_s, w1_q, w1_s, b1)
    got = mlp_int8_out_ref(codes, scales, w2_q, w2_s, b2, x)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(fused_mlp_int8_ref(*args), want)


@pytest.mark.parametrize("act", ["gelu_poly", "gelu"])
def test_hidden_zero_rows_take_the_scale_floor(act):
    """With b1 zero, an all-zero row of h_q (here the first, one in the
    middle and the last, as K4a's check on the card puts them in a tile's
    tail) activates to zeros: every chunk of it takes the 1e-8 scale and
    codes 0, and the other rows keep scales of their own."""
    h_q, h_s, w1_q, w1_s, b1 = _mlp_inputs(14, 40, f=2048)[:5]
    b1 = torch.zeros_like(b1)
    zero = [0, 20, 39]
    h_q[zero] = 0
    codes, scales = mlp_int8_hidden_ref(h_q, h_s, w1_q, w1_s, b1, act=act)
    assert torch.equal(scales[zero], torch.full((3, 2), 1e-8))
    assert not codes[zero].any()
    others = [r for r in range(40) if r not in zero]
    assert bool((scales[others] > 1e-8).all())
    assert bool((codes[others].abs().amax(1) == 127).all())


def test_k4_probe_rewrites_the_kernel_source():
    """tools/k4_probe.py finds each of its marked spans in this tree's
    fused_mlp_int8.cu: p2 takes out the value, codes and store spans and p3
    repeats p2's products span."""
    import importlib.util
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "k4_probe", repo / "tools" / "k4_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    source = (repo / "hirest_tpu_torch" / "ops" / "csrc" /
              "fused_mlp_int8.cu").read_text()
    p = probe.probes(source)
    assert p["p1"] == source
    for name in probe.SPANS:
        assert probe.span_re(name).search(source), name
    products = probe.span_re("products").search(source).group(1)
    for name in ("value", "codes", "store"):
        assert not probe.span_re(name).search(p["p2"]), name
    assert p["p2"].count(products) == 1
    assert p["p3"].count(2 * products) == 1


def test_fused_mlp_chunks_requant_separately():
    """Two 1024-unit chunks quantize the hidden units with two scales a
    row: the result differs from one chunk over all 2048 of them, and a
    chunk wider than F is that single chunk."""
    args = _mlp_inputs(6, 40, f=2048)
    two = fused_mlp_int8(*args)
    assert torch.equal(two, fused_mlp_int8_ref(*args, n_chunk=1024))
    one = fused_mlp_int8_ref(*args, n_chunk=4096)
    assert not torch.equal(two, one)
    assert torch.equal(one, fused_mlp_int8_ref(*args, n_chunk=2048))


def test_fused_mlp_bf16_residual_keeps_its_dtype():
    args = list(_mlp_inputs(7, 16, f=1024))
    args[-1] = args[-1].bfloat16()
    out = fused_mlp_int8(*args)
    assert out.dtype == torch.bfloat16
    ref = fused_mlp_int8_ref(*args[:-1], args[-1].float())
    torch.testing.assert_close(out.float(), ref, rtol=2 ** -7, atol=2 ** -7)


def test_fused_mlp_rejects_bad_chunk_and_act():
    args = _mlp_inputs(8, 8, f=1536)
    with pytest.raises(ValueError, match="not a multiple"):
        fused_mlp_int8(*args)
    with pytest.raises(ValueError, match="act must be"):
        fused_mlp_int8(*_mlp_inputs(8, 8, f=1024), act="relu")


def test_cpu_wrappers_take_plain_versions_without_counting():
    x, g, b = (torch.from_numpy(a) for a in _ln_inputs(9, 8))
    before = (ln_quant.launches, fused_mlp_int8.launches)
    q, s = ln_quant(x, g, b, EPS)
    rq, rs = ln_quant_ref(x, g, b, EPS)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    args = _mlp_inputs(9, 8, f=1024)
    assert torch.equal(fused_mlp_int8(*args), fused_mlp_int8_ref(*args))
    assert (ln_quant.launches, fused_mlp_int8.launches) == before


def test_wrappers_raise_on_a_device_without_kernels():
    """No silent fallback: a tensor that is neither on the CPU nor on CUDA
    raises instead of taking the plain version."""
    x = torch.empty((4, C), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ln_quant(x, torch.ones(C), torch.zeros(C), EPS)
    args = [a.to("meta") for a in _mlp_inputs(10, 4, f=1024)]
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp_int8(*args)
