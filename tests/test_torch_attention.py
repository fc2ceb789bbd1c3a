"""The port's attention kernels (hirest_tpu_torch/ops/attention.py) against
the JAX package's Pallas kernels (interpret mode): K1 and K3
(fused_attention_qkv3) at the real EVA-g attention shape [2, 257, 4224],
H=16, d=88, and at the padded head width 128; K6 (fused_attention) and K7
(fused_attention_packed) at the JAX package's own test shapes and EVA-g's;
K8 (fused_attention_qkv, v1) and K9 (fused_attention_qkv2, v2) at EVA-g's
shape and a small one.

On the CPU the port's wrapper takes its plain version, so these tests hold
the plain version's arithmetic against the TPU kernel's; the CUDA kernel is
held against the plain version on the card by chip_smoke.py. The CUDA
kernels' arithmetic is emulated here against the plain versions within the
card's bars, and the route rule (which wrapper, dtype, width and layout
reaches which instantiation, which views take a layout copy) is held
without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import assert_codes_close

from hirest_tpu.ops.attention import fused_attention as jax_fused_attention
from hirest_tpu.ops.attention import \
    fused_attention_packed as jax_fused_attention_packed
from hirest_tpu.ops.attention import fused_attention_qkv as jax_qkv1
from hirest_tpu.ops.attention import fused_attention_qkv2 as jax_qkv2
from hirest_tpu.ops.attention import fused_attention_qkv3 as jax_qkv3
from hirest_tpu_torch.models.layers import merge_heads, split_heads
from hirest_tpu_torch.ops.attention import (LOG2E, QKV3_CLUSTER_HEADS,
                                            _launch_qkv3, fused_attention,
                                            fused_attention_packed,
                                            fused_attention_packed_ref,
                                            fused_attention_qkv,
                                            fused_attention_qkv2,
                                            fused_attention_qkv2_ref,
                                            fused_attention_qkv3,
                                            fused_attention_qkv3_ref,
                                            fused_attention_qkv_ref,
                                            fused_attention_ref, qkv3_route,
                                            qkv3_shape, v1_plan, v1_route)
from hirest_tpu_torch.ops.quant import dyn_quant_rows

B, S, H, D = 2, 257, 16, 88
SCALE = D ** -0.5
LOG2E_F32 = torch.tensor(LOG2E, dtype=torch.float32)  # the kernels' log2(e)


def _qkv(seed=0):
    # scale 0.5 gives scores of order one after the 1/sqrt(d) scale
    return (np.random.default_rng(seed).normal(size=(B, S, 3 * H * D))
            * 0.5).astype(np.float32)


def test_plain_matches_jax_v3_f32():
    """f32 at 2e-5: the JAX package's own bar between its v1/v2/v3 kernels
    (test_eva_scan.py:97); only the summation order differs."""
    x = _qkv()
    want = np.asarray(jax_qkv3(jnp.asarray(x), SCALE, H, interpret=True))
    got = fused_attention_qkv3(torch.from_numpy(x), SCALE, H).numpy()
    assert got.shape == (B, S, H * D)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_matches_jax_v3_bf16():
    """bf16 in and out: within rtol 2**-7 (one to two bf16 ulps) plus
    2**-12 absolute for outputs near zero. p is rounded to bf16 in both, but
    a score that lands next to a rounding boundary may round the other way
    under another summation order, and the output itself rounds once to
    bf16."""
    x = _qkv(1)
    want = np.asarray(jax_qkv3(jnp.asarray(x, jnp.bfloat16), SCALE, H,
                               interpret=True).astype(jnp.float32))
    got = fused_attention_qkv3(torch.from_numpy(x).bfloat16(), SCALE, H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -12)


def test_cpu_tensor_takes_plain_version_without_counting():
    x = torch.from_numpy(_qkv(2))
    before = fused_attention_qkv3.launches
    out = fused_attention_qkv3(x, SCALE, H)
    assert fused_attention_qkv3.launches == before
    assert torch.equal(out, fused_attention_qkv3_ref(x, SCALE, H))


def test_rejects_qkv_not_divisible_by_heads():
    with pytest.raises(ValueError, match="heads"):
        fused_attention_qkv3(torch.zeros(1, 4, 3 * 10), 1.0, 4)


# --- K3: the int8 epilogue and the pad-key mask ---------------------------


def _quant_jax(x, dtype, n_real):
    q, s = jax_qkv3(jnp.asarray(x, dtype), SCALE, H, interpret=True,
                    quant_out=True, n_real=n_real)
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("s,n_real", [(257, 0), (264, 257)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_out_plain_matches_jax_v3(s, n_real, dtype):
    """Codes and row scales of the f32 attention output over all 16 heads,
    unpadded and token-padded to 264 with the pad keys masked. f32: scales
    within 2e-5 (the JAX v1/v2/v3 bar, test_eva_scan.py:97); bf16 (p
    rounded to bf16, which may round the other way under another summation
    order): within 2**-7. Codes within one; equal on 99.9 % (f32) and 99 %
    (bf16)."""
    x = (np.random.default_rng(3).normal(size=(B, s, 3 * H * D))
         * 0.5).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jq, js = _quant_jax(x, jdt, n_real)
    q, sc = fused_attention_qkv3(torch.from_numpy(x).to(tdt), SCALE, H,
                                 quant_out=True, n_real=n_real)
    assert q.dtype == torch.int8 and q.shape == (B, s, H * D)
    assert sc.dtype == torch.float32 and sc.shape == (B, s, 1)
    f32 = dtype == "float32"
    np.testing.assert_allclose(sc.numpy(), js, rtol=2e-5 if f32 else 2 ** -7)
    assert_codes_close(q.numpy(), jq, 0.999 if f32 else 0.99)


def test_padded_real_rows_equal_the_unpadded_run():
    """Pad keys get exactly zero weight: the first 257 rows of a run padded
    to 264 tokens (junk in the pad rows) are the unpadded run's."""
    x = (np.random.default_rng(4).normal(size=(B, 264, 3 * H * D))
         * 0.5).astype(np.float32)
    full = torch.from_numpy(x)
    q, s = fused_attention_qkv3(full, SCALE, H, quant_out=True, n_real=257)
    q0, s0 = fused_attention_qkv3(full[:, :257].contiguous(), SCALE, H,
                                  quant_out=True)
    assert_codes_close(q[:, :257].numpy(), q0.numpy(), 0.9999)
    np.testing.assert_allclose(s[:, :257].numpy(), s0.numpy(), rtol=1e-6)
    bf = fused_attention_qkv3(full, SCALE, H, n_real=257)
    np.testing.assert_allclose(bf[:, :257].numpy(),
                               fused_attention_qkv3(full[:, :257], SCALE, H)
                               .numpy(), rtol=1e-6, atol=1e-6)


def test_quant_out_is_not_the_bf16_output_quantized():
    """The epilogue quantizes the f32 output, never rounded to bf16 first."""
    x = torch.from_numpy(_qkv(5)).bfloat16()
    q, s = fused_attention_qkv3(x, SCALE, H, quant_out=True)
    o = fused_attention_qkv3(x, SCALE, H).float()
    sq = (o.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    assert not torch.equal(q, torch.round(o / sq).clamp(-127, 127)
                           .to(torch.int8))
    torch.testing.assert_close(s, sq, rtol=2 ** -7, atol=0)


def test_cpu_quant_call_counts_nothing():
    x = torch.from_numpy(_qkv(6))
    before = (fused_attention_qkv3.launches,
              fused_attention_qkv3.quant_launches)
    q, s = fused_attention_qkv3(x, SCALE, H, quant_out=True)
    rq, rs = fused_attention_qkv3_ref(x, SCALE, H, quant_out=True)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert (fused_attention_qkv3.launches,
            fused_attention_qkv3.quant_launches) == before


# --- K1 and K3 at the padded head width -----------------------------------

D128 = 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_v3_at_padded_head_width(dtype):
    """K1's plain version at d=128 (heads padded by models/eva_pad.py)
    against the JAX v3 kernel: f32 at 2e-5, bf16 at K1's bar."""
    x = (np.random.default_rng(20).normal(size=(B, S, 3 * H * D128))
         * 0.5).astype(np.float32)
    scale = D128 ** -0.5
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_qkv3(jnp.asarray(x, jdt), scale, H,
                               interpret=True).astype(jnp.float32))
    got = fused_attention_qkv3(torch.from_numpy(x).to(tdt), scale, H)
    assert got.shape == (B, S, H * D128)
    tol = (2e-5, 2e-5) if dtype == "float32" else (2 ** -7, 2 ** -12)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol[0],
                               atol=tol[1])


def test_quant_out_plain_matches_jax_v3_at_padded_head_width():
    """K3's plain version at d=128: scales within 2e-5, codes within one and
    equal on 99.9 %, in f32."""
    x = (np.random.default_rng(21).normal(size=(B, S, 3 * H * D128))
         * 0.5).astype(np.float32)
    scale = D128 ** -0.5
    jq, js = jax_qkv3(jnp.asarray(x), scale, H, interpret=True,
                      quant_out=True)
    q, sc = fused_attention_qkv3(torch.from_numpy(x), scale, H,
                                 quant_out=True)
    np.testing.assert_allclose(sc.numpy(), np.asarray(js), rtol=2e-5)
    assert_codes_close(q.numpy(), np.asarray(jq), 0.999)


# --- K6 and K7: split-heads and packed-heads attention ---------------------

# (B, H, Sq, Sk, D, valid keys or None): the JAX package's own test shapes
# (tests/test_pallas_attention.py), the caption decoder's cross-attention
# [2, 12, 48, 64] over 20 keys, one real EVA-g head set, and the streamed
# CUDA body's edges: every key masked (uniform p), and 600 keys over 33
# queries (more keys than a staged head fits in shared memory, a ragged
# last query tile)
SPLIT_CASES = {
    "square": (2, 4, 17, 17, 8, None),
    "masked": (2, 12, 48, 48, 64, 43),
    "rectangular": (2, 12, 48, 20, 64, None),
    "masked_rectangular": (2, 12, 48, 20, 64, 15),
    "eva_g": (1, 16, 257, 257, 88, None),
    "all_masked": (2, 4, 17, 20, 64, 0),
    "long_keys": (1, 2, 33, 600, 128, 590),
}
PACKED_CASES = {**SPLIT_CASES, "eva_g_padded": (1, 16, 257, 257, 128, None)}


def _split_inputs(case, seed):
    """q, k, v, the key mask and the scale of a (B, H, Sq, Sk, D, valid)
    case; valid: None (no mask), the valid keys of every batch row, or a
    tuple of them, one a batch row."""
    b, h, sq, sk, d, n_valid = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    if isinstance(n_valid, tuple):
        mask = np.stack([np.arange(sk) < n for n in n_valid]).astype(np.int32)
    else:
        mask = None if n_valid is None else (
            np.arange(sk) < n_valid)[None].repeat(b, 0).astype(np.int32)
    return q, k, v, mask, d ** -0.5


def _pack(x):
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b, s, h * d)


def _assert_attention_close(got, want, dtype):
    """f32 within 2e-5, the JAX package's Pallas-vs-XLA bar
    (test_pallas_attention.py); bf16 within one bf16 ulp of the output's
    largest magnitude (p may round the other way at a bf16 boundary under
    another summation order, and the output rounds once to bf16)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


def _dtypes(dtype):
    return ((jnp.float32, torch.float32) if dtype == "float32"
            else (jnp.bfloat16, torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_heads_plain_matches_jax_pallas(case, dtype):
    """K6's plain version against the JAX Pallas kernel `fused_attention`
    (interpret mode)."""
    q, k, v, mask, scale = _split_inputs(SPLIT_CASES[case], seed=30)
    jdt, tdt = _dtypes(dtype)
    want = jax_fused_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), scale,
        key_mask=None if mask is None else jnp.asarray(mask),
        use_pallas=True, interpret=True).astype(jnp.float32)
    got = fused_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          scale, None if mask is None
                          else torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == q.shape
    _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_heads_plain_matches_jax_pallas(case, dtype):
    """K7's plain version against the JAX Pallas kernel
    `fused_attention_packed` (interpret mode)."""
    q, k, v, mask, scale = _split_inputs(PACKED_CASES[case], seed=31)
    h = q.shape[1]
    q, k, v = _pack(q), _pack(k), _pack(v)
    jdt, tdt = _dtypes(dtype)
    want = jax_fused_attention_packed(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), scale, h,
        key_mask=None if mask is None else jnp.asarray(mask),
        use_pallas=True, interpret=True).astype(jnp.float32)
    got = fused_attention_packed(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), scale, h,
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == q.shape
    _assert_attention_close(got, want, dtype)


def test_split_and_packed_are_one_function():
    """K7 is K6 with the heads left in place; the mask matters; a query
    tile whose keys are all masked attends uniformly, as -1e30 gives."""
    q, k, v, mask, scale = _split_inputs(SPLIT_CASES["masked_rectangular"],
                                         seed=32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    split = fused_attention(tq, tk, tv, scale, tm)
    packed = fused_attention_packed(*(torch.from_numpy(_pack(a))
                                      for a in (q, k, v)), scale, q.shape[1],
                                    tm)
    torch.testing.assert_close(packed, split.transpose(1, 2).flatten(2),
                               rtol=0, atol=0)
    assert (split - fused_attention(tq, tk, tv, scale)).abs().max() > 1e-3
    none = fused_attention(tq, tk, tv, scale, torch.zeros_like(tm))
    torch.testing.assert_close(none, tv.mean(2, keepdim=True).expand_as(none),
                               rtol=1e-5, atol=1e-5)


def _streamed_softmax_f32(q, k, v, scale, key_mask=None, key_tile=64):
    """The arithmetic of attention_qkv3.cu's v1 form (K6, K7, K8) in f32 on
    the CPU, up to its f32 PV product: scores scaled and rounded on their
    own, masked keys -1e30, a running (max, sum) a row folded one 64-key
    tile at a time (the tile's row max first, the sum rescaled once), exp
    as 2^(s log2e - m log2e) with m log2e rounded and the rest one fused
    multiply-add (exact in f64, then rounded), or with a key mask
    2^((s - m) log2e) rounded step by step, p = bf16(e * r) with r = 1/l
    rounded once a row, f32 PV."""

    def exp(x, m):
        if key_mask is not None:
            return torch.exp2((x - m) * LOG2E_F32)
        return torch.exp2((x.double() * LOG2E_F32
                           - (m * LOG2E_F32).double()).float())

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        valid = (key_mask != 0)[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    for k0 in range(0, s.shape[-1], key_tile):
        tile = s[..., k0:k0 + key_tile]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        l = (l * torch.exp2((m - m_new) * LOG2E_F32)
             + exp(tile, m_new).sum(-1, keepdim=True))
        m = m_new
    p = (exp(s, m) * torch.reciprocal(l)).bfloat16()
    return torch.matmul(p.float(), v.float())


def _streamed_qkv_attention(qkv, q_bias, v_bias, scale, heads,
                            quant_out=False):
    """K8 on the v1 form, emulated: the q and v biases added in bf16 (the
    f32 sum rounded once, as the kernel's add_bf16x2 and PyTorch's bf16
    add round it), then `_streamed_softmax_f32` per head; the output
    rounded to bf16, or with quant_out the int8 codes and row scales of the
    f32 output (the kernel's epilogue quantizes its f32 accumulators)."""
    q, k, v = qkv.chunk(3, -1)
    q, v = q + q_bias.bfloat16(), v + v_bias.bfloat16()
    o = merge_heads(_streamed_softmax_f32(
        *(split_heads(t, heads) for t in (q, k, v)), scale))
    return dyn_quant_rows(o) if quant_out else o.bfloat16()


# case -> (attention, its shape): K6 and K7 on split heads at EVA-g's shapes
# (PACKED_CASES), at ViT-B/32's d = 64, masked (the caption decoder's
# cross-attention shape, one batch row's keys also all masked), and 33
# queries over 600 keys (d = 88 masked, d = 128); and K8 on fused qkv with
# nonzero biases, (B, S, H, d), at EVA-g's head width, at 128 and 64, over
# 600 tokens, and with the int8 epilogue (16 heads: the cluster epilogue;
# 12: the two-step one, the same arithmetic)
STREAMED_CASES = {
    "eva_g": ("split", PACKED_CASES["eva_g"]),
    "eva_g_padded": ("split", PACKED_CASES["eva_g_padded"]),
    "vit_b32_d64": ("split", (2, 12, 50, 50, 64, None)),
    "masked_d64": ("split", (2, 12, 48, 20, 64, (15, 15))),
    "all_masked_batch_row": ("split", (2, 12, 48, 20, 64, (15, 0))),
    "long_keys_masked": ("split", (2, 16, 33, 600, 88, (590, 600))),
    "long_keys_d128": ("split", (2, 16, 33, 600, 128, None)),
    "k8_eva_g": ("qkv", (2, 257, 16, 88)),
    "k8_eva_g_d128": ("qkv", (2, 257, 16, 128)),
    "k8_d64": ("qkv", (2, 50, 12, 64)),
    "k8_long": ("qkv", (2, 600, 16, 88)),
    "k8q_eva_g": ("qkv_quant", (2, 257, 16, 88)),
    "k8q_d64_two_step": ("qkv_quant", (2, 50, 12, 64)),
}


@pytest.mark.parametrize("case", list(STREAMED_CASES))
def test_streamed_arithmetic_within_the_card_bar(case):
    """The arithmetic of the kernel's v1 form, emulated in f32, against
    the plain version in bf16 within chip_smoke.py's card bar, 2**-7 of
    the output's largest magnitude: K6 (d=88) and K7 (d=128) at EVA-g's
    shapes (B=1, 257 tokens), at d=64, masked (a batch row whose keys are
    all masked attends uniformly) and over 600 keys; K8 (biased) at d=88,
    128 and 64 and over 600 tokens; K8's int8 epilogue at K3's card bar,
    codes within one and equal on 99 %, scales within 2**-7. Its
    tolerance budget, checked before the card."""
    kind, shape = STREAMED_CASES[case]
    # over more than one 64-key tile the running fold rounds otherwise than
    # the reference; over one tile the emulation may give its very bits
    keys = shape[3] if kind == "split" else shape[1]
    if kind == "split":
        q, k, v, mask, scale = _split_inputs(shape, seed=34)
        tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
        tm = None if mask is None else torch.from_numpy(mask)
        got = _streamed_softmax_f32(tq, tk, tv, scale, tm).bfloat16()
        want = fused_attention_ref(tq, tk, tv, scale, tm)
    else:
        x, qb, vb, h, scale = _biased_qkv(shape, seed=35)
        t, tqb, tvb = (torch.from_numpy(a) for a in (x, qb, vb))
        t = t.bfloat16()
        quant = kind == "qkv_quant"
        got = _streamed_qkv_attention(t, tqb, tvb, scale, h, quant)
        want = fused_attention_qkv_ref(t, tqb, tvb, scale, h,
                                       quant_out=quant)
        if quant:
            (q, sc), (rq, rs) = got, want
            torch.testing.assert_close(sc, rs, rtol=2 ** -7, atol=0)
            assert_codes_close(q.numpy(), rq.numpy(), 0.99)
            assert keys <= 64 or not torch.equal(sc, rs)
            return
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2 ** -7 * top
    assert keys <= 64 or not torch.equal(got, want)


def _qkv3_wgmma_attention(qkv, scale, heads, n_real=0, quant_out=False):
    """attention_qkv3.cu's arithmetic (K1, K3, K9) emulated in f32 on the
    CPU: unscaled f32 scores, the exact row max over the keys below
    n_real, p = bf16(2^(s c - m c)) with c = scale log2e and m c each
    rounded to f32 and the argument one fused multiply-add (exact in f64,
    then rounded), keys at or past n_real left out (p = 0), the f32 sum of
    the rounded p, f32 PV multiplied by 1/sum rounded once a row; the
    output rounded to bf16, or with quant_out the int8 codes and row
    scales of the f32 output."""
    b, s, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    q, k, v = qkv.float().view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    n = n_real or s
    sc = torch.matmul(q, k[..., :n, :].transpose(-1, -2))
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    mc = sc.amax(-1, keepdim=True) * c
    p = torch.exp2((sc.double() * c.double() - mc.double()).float())
    p = p.bfloat16().float()
    o = torch.matmul(p, v[..., :n, :]) * torch.reciprocal(
        p.sum(-1, keepdim=True))
    o = merge_heads(o)
    return dyn_quant_rows(o) if quant_out else o.bfloat16()


# case -> ((B, S, H, d), n_real, int8 out): K1 at EVA-g's head width and at
# the padded 128, K3 on rows padded to 264 tokens with n_real = 257
QKV3_CARD_CASES = {
    "k1_eva_g": ((2, 257, 16, 88), 0, False),
    "k1_eva_g_d128": ((2, 257, 16, 128), 0, False),
    "k3_eva_g_padded_rows": ((2, 264, 16, 88), 257, True),
}


@pytest.mark.parametrize("case", list(QKV3_CARD_CASES))
def test_qkv3_wgmma_arithmetic_within_the_card_bar(case):
    """The arithmetic of attention_qkv3.cu's wgmma body, emulated in f32,
    against the plain version in bf16, within chip_smoke.py's card bars:
    K1 within 2**-7 of the output's largest magnitude; K3 codes within
    one and equal on 99 %, scales within 2**-7. Its tolerance budget,
    checked before the card."""
    (b, s, h, d), n_real, quant = QKV3_CARD_CASES[case]
    rng = np.random.default_rng(46)
    x = torch.from_numpy((rng.normal(size=(b, s, 3 * h * d)) * 0.5)
                         .astype(np.float32)).bfloat16()
    got = _qkv3_wgmma_attention(x, d ** -0.5, h, n_real, quant)
    want = fused_attention_qkv3_ref(x, d ** -0.5, h, quant_out=quant,
                                    n_real=n_real)
    if quant:
        (q, sc), (rq, rs) = got, want
        torch.testing.assert_close(sc, rs, rtol=2 ** -7, atol=0)
        assert_codes_close(q.numpy(), rq.numpy(), 0.99)
        assert not torch.equal(sc, rs)  # the arithmetic does differ
        return
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2 ** -7 * top
    assert not torch.equal(got, want)  # the arithmetic does differ


def test_split_cpu_calls_take_plain_versions_without_counting():
    q, k, v, mask, scale = _split_inputs(SPLIT_CASES["square"], seed=33)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = (fused_attention.launches, fused_attention_packed.launches)
    assert torch.equal(fused_attention(tq, tk, tv, scale),
                       fused_attention_ref(tq, tk, tv, scale))
    pq, pk, pv = (torch.from_numpy(_pack(a)) for a in (q, k, v))
    assert torch.equal(fused_attention_packed(pq, pk, pv, scale, 4),
                       fused_attention_packed_ref(pq, pk, pv, scale, 4))
    assert (fused_attention.launches,
            fused_attention_packed.launches) == before


# --- K8: v1 attention, q/v biases added in the kernel ----------------------

# (B, S, H, d): EVA-g's attention and a small one of the JAX tests' kind
QKV_CASES = {"eva_g": (2, 257, 16, 88), "small": (2, 17, 4, 8)}


def _qkv_and_biases(case, seed):
    return _biased_qkv(QKV_CASES[case], seed)


def _biased_qkv(shape, seed):
    """qkv [B, S, 3*H*d] and q/v biases [H*d] for shape (B, S, H, d)."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    qkv = (rng.normal(size=(b, s, 3 * h * d)) * 0.5).astype(np.float32)
    # nonzero biases of the size the qkv values have, so that adding them
    # moves the scores
    qb, vb = (rng.normal(size=h * d).astype(np.float32) * 0.5
              for _ in range(2))
    return qkv, qb, vb, h, d ** -0.5


@pytest.mark.parametrize("quant_out", [False, True], ids=["bf16out", "quant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(QKV_CASES))
def test_qkv_v1_plain_matches_jax_pallas(case, dtype, quant_out):
    """K8's plain version against the JAX Pallas kernel
    `fused_attention_qkv` (interpret mode), biases nonzero. f32 within
    1e-5 (K6's softmax in another summation order); bf16 at K6's bar, one
    bf16 ulp of the output's largest magnitude (the biases are added in
    bf16 in both, p may round the other way at a boundary). quant_out:
    scales within 1e-5 (f32) or 2**-7 (bf16), codes within one and equal on
    99.9 % (f32) or 99 % (bf16), K3's bars."""
    x, qb, vb, h, scale = _qkv_and_biases(case, seed=40)
    jdt, tdt = _dtypes(dtype)
    want = jax_qkv1(jnp.asarray(x, jdt), jnp.asarray(qb), jnp.asarray(vb),
                    scale, h, interpret=True, quant_out=quant_out)
    got = fused_attention_qkv(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(qb), torch.from_numpy(vb),
                              scale, h, quant_out=quant_out)
    f32 = dtype == "float32"
    if quant_out:
        (q, sc), (jq, js) = got, want
        assert q.dtype == torch.int8 and q.shape == (*x.shape[:2],
                                                     x.shape[-1] // 3)
        assert sc.dtype == torch.float32 and sc.shape == (*x.shape[:2], 1)
        np.testing.assert_allclose(sc.numpy(), np.asarray(js),
                                   rtol=1e-5 if f32 else 2 ** -7)
        assert_codes_close(q.numpy(), np.asarray(jq), 0.999 if f32 else 0.99)
    else:
        assert got.dtype == tdt and got.shape == (*x.shape[:2],
                                                  x.shape[-1] // 3)
        want = np.asarray(want.astype(jnp.float32))
        if f32:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        else:
            _assert_attention_close(got, want, dtype)


def test_qkv_v1_is_split_attention_on_biased_thirds():
    """K8 adds the biases in qkv's dtype and then computes K6's function:
    bit-equal in f32 to K7's plain version on the biased thirds, and the
    biases matter. The v1 softmax is not v3's: they differ beyond f32
    rounding in bf16."""
    x, qb, vb, h, scale = _qkv_and_biases("small", seed=41)
    t = torch.from_numpy(x)
    q, k, v = t.chunk(3, -1)
    tqb, tvb = torch.from_numpy(qb), torch.from_numpy(vb)
    got = fused_attention_qkv(t, tqb, tvb, scale, h)
    assert torch.equal(got, fused_attention_packed_ref(q + tqb, k, v + tvb,
                                                       scale, h))
    zero = torch.zeros_like(tqb)
    assert (got - fused_attention_qkv(t, zero, zero, scale, h)).abs().max() > 0.1
    tb = t.bfloat16()
    v1 = fused_attention_qkv(tb, zero, zero, scale, h).float()
    v3 = fused_attention_qkv3(tb, scale, h).float()
    assert not torch.equal(v1, v3)


def test_qkv_v1_cpu_calls_count_nothing():
    x, qb, vb, h, scale = _qkv_and_biases("small", seed=42)
    t, tqb, tvb = (torch.from_numpy(a) for a in (x, qb, vb))
    before = (fused_attention_qkv.launches,
              fused_attention_qkv.quant_launches)
    for quant_out in (False, True):
        got = fused_attention_qkv(t, tqb, tvb, scale, h, quant_out=quant_out)
        want = fused_attention_qkv_ref(t, tqb, tvb, scale, h,
                                       quant_out=quant_out)
        for a, w in zip(*((got, want) if quant_out else ((got,), (want,)))):
            assert torch.equal(a, w)
    assert (fused_attention_qkv.launches,
            fused_attention_qkv.quant_launches) == before


# --- K9: v2 attention, K1/K3's function head by head on the TPU ------------


@pytest.mark.parametrize("s,n_real", [(257, 0), (264, 257)])
@pytest.mark.parametrize("quant_out", [False, True], ids=["bf16out", "quant"])
def test_qkv_v2_plain_matches_jax_pallas(quant_out, s, n_real):
    """K9's plain version against the JAX Pallas kernel
    `fused_attention_qkv2` (interpret mode) at EVA-g's shape, unpadded and
    token-padded to 264 with the pad keys masked, in f32 at K1/K3's bars:
    outputs within 2e-5, scales within 2e-5 and codes within one and equal
    on 99.9 %."""
    x = (np.random.default_rng(43).normal(size=(B, s, 3 * H * D))
         * 0.5).astype(np.float32)
    want = jax_qkv2(jnp.asarray(x), SCALE, H, interpret=True,
                    quant_out=quant_out, n_real=n_real)
    got = fused_attention_qkv2(torch.from_numpy(x), SCALE, H,
                               quant_out=quant_out, n_real=n_real)
    if quant_out:
        (q, sc), (jq, js) = got, want
        assert q.dtype == torch.int8 and q.shape == (B, s, H * D)
        np.testing.assert_allclose(sc.numpy(), np.asarray(js), rtol=2e-5)
        assert_codes_close(q.numpy(), np.asarray(jq), 0.999)
    else:
        assert got.shape == (B, s, H * D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_qkv_v2_bf16_plain_matches_jax_pallas():
    """bf16 in and out at K1's bar (rtol 2**-7, atol 2**-12)."""
    x = _qkv(44)
    want = np.asarray(jax_qkv2(jnp.asarray(x, jnp.bfloat16), SCALE, H,
                               interpret=True).astype(jnp.float32))
    got = fused_attention_qkv2(torch.from_numpy(x).bfloat16(), SCALE, H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -12)


def test_qkv_v2_is_v3_and_counts_apart():
    """v2 and v3 are one function (their plain versions are one), and a
    CPU call counts neither kernel's launches."""
    x = torch.from_numpy(_qkv(45)).bfloat16()
    before = (fused_attention_qkv2.launches,
              fused_attention_qkv2.quant_launches,
              fused_attention_qkv3.launches,
              fused_attention_qkv3.quant_launches)
    assert fused_attention_qkv2_ref is fused_attention_qkv3_ref
    assert torch.equal(fused_attention_qkv2(x, SCALE, H),
                       fused_attention_qkv3(x, SCALE, H))
    q2, s2 = fused_attention_qkv2(x, SCALE, H, quant_out=True, n_real=200)
    q3, s3 = fused_attention_qkv3(x, SCALE, H, quant_out=True, n_real=200)
    assert torch.equal(q2, q3) and torch.equal(s2, s3)
    assert (fused_attention_qkv2.launches,
            fused_attention_qkv2.quant_launches,
            fused_attention_qkv3.launches,
            fused_attention_qkv3.quant_launches) == before


# K3's epilogue by head count: (qkv shape, heads, quant_out) -> route. The
# cluster epilogue takes EVA-g's 16 heads of 88 and the padded heads' 16 of
# 128; another head count keeps the two-step epilogue
QKV3_ROUTES = {"EVA-g int8": ((2, 257, 4224), 16, True, "cluster"),
               "padded heads int8": ((2, 257, 6144), 16, True, "cluster"),
               "8 heads int8": ((2, 257, 3 * 8 * 88), 8, True, "two_step"),
               "24 heads int8": ((2, 33, 3 * 24 * 128), 24, True,
                                 "two_step"),
               "EVA-g bf16 out": ((2, 257, 4224), 16, False, "bf16")}


@pytest.mark.parametrize("case", QKV3_ROUTES)
def test_qkv3_route_rule(case):
    shape, heads, quant_out, want = QKV3_ROUTES[case]
    assert qkv3_route(heads, quant_out) == want
    assert qkv3_shape(torch.bfloat16, shape, heads, quant_out) == want
    assert (qkv3_route(QKV3_CLUSTER_HEADS, True) == "cluster"
            and QKV3_CLUSTER_HEADS == H)


# what attention_qkv3.cu refuses: (dtype, shape, heads, contiguous,
# aligned) -> the error
QKV3_REFUSED = {
    "heads not dividing qkv": (torch.bfloat16, (2, 257, 4224), 15, True,
                               True, ValueError),
    "head width 64": (torch.bfloat16, (2, 257, 3 * 16 * 64), 16, True, True,
                      ValueError),
    "f16": (torch.float16, (2, 257, 4224), 16, True, True, TypeError),
    "2-d qkv": (torch.bfloat16, (257, 4224), 16, True, True, ValueError),
    "a strided view": (torch.bfloat16, (2, 257, 4224), 16, False, True,
                       ValueError),
    "8-byte aligned": (torch.bfloat16, (2, 257, 4224), 16, True, False,
                       ValueError)}


@pytest.mark.parametrize("case", QKV3_REFUSED)
def test_qkv3_shape_refuses_what_the_kernel_does_not_take(case):
    dtype, shape, heads, contiguous, aligned, error = QKV3_REFUSED[case]
    for quant_out in (False, True):
        with pytest.raises(error):
            qkv3_shape(dtype, shape, heads, quant_out, contiguous, aligned)


@pytest.mark.parametrize("heads,quant_out", [(8, True), (16, False)],
                         ids=["two-step heads", "bf16 out"])
def test_launch_refuses_a_cluster_variant_off_its_route(heads, quant_out):
    """A cluster variant (heads_per_block) asked of a call the cluster
    epilogue does not take raises before anything is built or launched."""
    qkv = torch.zeros((1, 5, 3 * heads * 88), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="heads_per_block"):
        _launch_qkv3(qkv, SCALE, heads, quant_out, 0, heads_per_block=2)


# --- K6, K7 and K8 on attention_qkv3.cu's v1 form: the route rule ---------

# (heads, masked, biased, quant_out) -> the v1 form's instantiation
V1_ROUTES = {
    "K6/K7": ((16, False, False, False), "v1"),
    "K6/K7 key mask": ((12, True, False, False), "v1 masked"),
    "K8 bf16 out": ((16, False, True, False), "v1 biased"),
    "K8 int8 at 16 heads": ((16, False, True, True), "v1 biased cluster"),
    "K8 int8 at 12 heads": ((12, False, True, True), "v1 biased two_step"),
}


@pytest.mark.parametrize("case", V1_ROUTES)
def test_v1_route_rule(case):
    """K8's int8 epilogue takes the cluster epilogue where K3 does (16
    heads), else the two-step one; K6/K7 take the mask apart."""
    (heads, masked, biased, quant_out), want = V1_ROUTES[case]
    assert v1_route(heads, masked=masked, biased=biased,
                    quant_out=quant_out) == want
    if quant_out:
        assert want.endswith(qkv3_route(heads, True))


@pytest.mark.parametrize("kwargs", [dict(masked=True, biased=True),
                                    dict(quant_out=True),
                                    dict(masked=True, quant_out=True)],
                         ids=["mask and biases", "K6 int8", "masked int8"])
def test_v1_route_refuses_what_no_instantiation_takes(kwargs):
    with pytest.raises(ValueError):
        v1_route(16, **kwargs)


def _bf16(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).bfloat16()


def _qkv_thirds(b, s, h, d, seed=0):
    """q, k, v as [B, H, S, d] views of one bf16 [B, S, 3 H d] tensor."""
    return [split_heads(t, h) for t in _bf16(b, s, 3 * h * d,
                                             seed=seed).chunk(3, -1)]


def _layouts():
    """layout -> (q, k, v, key mask, views that take a copy): the wrappers'
    own layouts, none copied, and views the TMA maps cannot take."""
    packed = [split_heads(_bf16(2, 65, 16 * 128, seed=i), 16)
              for i in range(3)]
    heads_outer = [_bf16(2, 12, n, 64, seed=i)
                   for i, n in enumerate((48, 20, 20))]
    odd_rows = [split_heads(_bf16(2, 65, 16 * 88 + 4, seed=i)
                            [..., :16 * 88], 16) for i in range(3)]
    offset = _bf16(2 * 65 * 16 * 88 + 4)[4:].view(2, 65, 16 * 88)
    misaligned = [split_heads(offset, 16)] + _qkv_thirds(2, 65, 16, 88)[1:]
    strided_d = [t.transpose(-1, -2).contiguous().transpose(-1, -2)
                 for t in _qkv_thirds(2, 33, 4, 64)]
    broadcast = [_bf16(1, 4, 33, 64, seed=i).expand(2, 4, 33, 64)
                 for i in range(3)]
    mask = torch.ones(2, 20, dtype=torch.int32)
    return {
        "K6/K8 thirds of one projection": (*_qkv_thirds(2, 65, 16, 88), None,
                                           ()),
        "K7 packed heads": (*packed, None, ()),
        "K6 contiguous split heads, masked": (*heads_outer, mask, ()),
        "rows 8 bytes apart from a multiple of 16": (*odd_rows, None,
                                                     (0, 1, 2)),
        "q 8 bytes off 16-byte alignment": (*misaligned, None, (0,)),
        "column-major head rows": (*strided_d, None, (0, 1, 2)),
        "a broadcast batch": (*broadcast, None, (0, 1, 2)),
    }


@pytest.mark.parametrize("layout", list(_layouts()))
def test_v1_plan_copies_only_what_the_tma_maps_cannot_take(layout):
    """v1_plan hands the kernel the wrappers' views as they are (heads
    inner or outer, any positive strides 16 bytes apart) and a contiguous
    copy of the same values for any other view; the strides it passes are
    those of what it hands over, positive multiples of 8 elements."""
    q, k, v, mask, copied = _layouts()[layout]
    plan = v1_plan(q, k, v, mask)
    assert plan["route"] == ("v1" if mask is None else "v1 masked")
    b, h, sq, d = q.shape
    assert plan["shape"] == (b, h, sq, k.shape[2], d)
    for i, (t, got) in enumerate(zip((q, k, v), plan["views"])):
        assert (got is not t) == (i in copied)
        assert torch.equal(got, t)
        if i in copied:
            assert got.is_contiguous()
    assert plan["strides"] == tuple(st for t in plan["views"]
                                    for st in t.stride()[:3])
    assert all(st > 0 and st % 8 == 0 for st in plan["strides"])


# what the v1 form refuses: (q, k, v, mask) -> the error
def _refused():
    q, k, v = _qkv_thirds(2, 33, 4, 64)
    return {
        "f16": ((q.half(), k.half(), v.half(), None), TypeError),
        "f32 with bf16": ((q.float(), k, v, None), TypeError),
        "head width 80": ((*_qkv_thirds(2, 33, 4, 80), None), ValueError),
        "k and v apart": ((q, k, v[:, :, :20], None), ValueError),
        "mask of another key count": (
            (q, k, v, torch.ones(2, 20, dtype=torch.int32)), ValueError),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_v1_plan_refuses_what_the_kernel_does_not_take(case):
    args, error = _refused()[case]
    with pytest.raises(error):
        v1_plan(*args)


def test_wrappers_route_bf16_to_the_v1_form_and_f32_to_the_f32_body(
        monkeypatch):
    """Which launch each wrapper makes on a CUDA tensor, held without a GPU
    (the launches recorded, with their v1_plan route, in place of the
    kernels): bf16 K6 (its key mask with it: "v1 masked"), K7 (the split
    views of its packed tensors: "v1") and K8 (bf16 biases: "v1 biased";
    quant_out at 16 heads with no output tensor: "v1 biased cluster")
    launch the v1 form into a [B, Sq, H*D] output, f32 launches the f32
    body, f16 raises; each counts its launch under its wrapper's
    counter."""
    from hirest_tpu_torch.ops import attention as attn
    calls = []

    def v1(q, k, v, key_mask, out, scale, q_bias=None, v_bias=None, **kw):
        plan = attn.v1_plan(q, k, v, key_mask, q_bias is not None,
                            out is None)
        calls.append((plan["route"], (q, k, v, key_mask, out, q_bias,
                                      v_bias)))
        return ("codes", "scales") if out is None else out

    monkeypatch.setattr(attn, "_on_cuda", lambda x: True)
    monkeypatch.setattr(attn, "_launch_v1", v1)
    monkeypatch.setattr(attn, "_launch_f32", lambda *a, **kw: calls.append(
        ("f32", a)))
    q, k, v = _qkv_thirds(2, 65, 16, 88)
    mask = torch.ones(2, 65, dtype=torch.int32)
    before = (fused_attention.launches, fused_attention.launches_f32,
              fused_attention_packed.launches, fused_attention_qkv.launches,
              fused_attention_qkv.quant_launches)
    out = fused_attention(q, k, v, SCALE, mask)
    route, a = calls.pop()
    assert route == "v1 masked" and a[:4] == (q, k, v, mask)
    assert a[4].shape == (2, 65, 16 * 88) and a[4].dtype == torch.bfloat16
    assert out.shape == q.shape and out.data_ptr() == a[4].data_ptr()
    merged = merge_heads(out)  # a view of what the kernel writes
    assert (merged.data_ptr(), merged.stride()) == (a[4].data_ptr(),
                                                     a[4].stride())
    fused_attention(q.float(), k.float(), v.float(), SCALE)
    assert calls.pop()[0] == "f32"
    packed = [merge_heads(t).contiguous() for t in (q, k, v)]
    out = fused_attention_packed(*packed, SCALE, 16)
    route, a = calls.pop()
    assert route == "v1" and a[4] is out and a[3] is None
    assert all(torch.equal(x, split_heads(p, 16)) for x, p in
               zip(a[:3], packed))
    qkv = _bf16(2, 65, 3 * 16 * 88)
    qb, vb = torch.ones(16 * 88), torch.zeros(16 * 88)
    out = fused_attention_qkv(qkv, qb, vb, SCALE, 16)
    route, a = calls.pop()
    assert route == "v1 biased" and a[4] is out and a[3] is None
    assert a[5].dtype == a[6].dtype == torch.bfloat16
    assert torch.equal(a[5].float(), qb) and torch.equal(a[6].float(), vb)
    assert fused_attention_qkv(qkv, qb, vb, SCALE, 16,
                               quant_out=True) == ("codes", "scales")
    route, a = calls.pop()
    assert route == "v1 biased cluster" and a[4] is None
    for call in (lambda: fused_attention(q.half(), k.half(), v.half(),
                                         SCALE),
                 lambda: fused_attention_qkv(qkv.half(), qb, vb, SCALE, 16)):
        with pytest.raises(TypeError):
            call()
    assert not calls
    assert (fused_attention.launches, fused_attention.launches_f32,
            fused_attention_packed.launches, fused_attention_qkv.launches,
            fused_attention_qkv.quant_launches) == tuple(
                n + 1 for n in before)
