"""The arithmetic of the f32 attention body (ops/csrc/attention_f32.cu),
modelled on the CPU and held to the card's bar before the card.

The body takes its products on the tensor cores in 3xTF32: each f32 operand
x split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: to nearest, ties
away from zero), each product as lo hi' + hi lo' + hi hi' into one f32
accumulator; the softmax in f32, online over 32-key tiles, and after PV
the output times the correctly rounded reciprocal of the row sum.
`_tf32x3_attention` models that (each product's three terms summed in f64
and rounded once to f32: the model does not round sums as the tensor cores
do), and the tests hold it within chip_smoke.py's F32_TOL = 1e-5 of the
output's largest magnitude of the plain version (`_softmax_attention_f32`)
and of the JAX package's f32 kernels in interpret mode, at ViT-B/32's head
shape, EVA-g's (K1's layout, n_real) and the padded head width 128, and
with one batch row's keys all masked.
One pass of TF32 misses that bar, which is why the body takes three.
`python tests/test_torch_attention_tf32x3.py` prints the model's errors
against an f64 product, one pass and three, at each case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hirest_tpu.ops.attention import fused_attention as jax_fused_attention
from hirest_tpu.ops.attention import fused_attention_qkv3 as jax_qkv3
from hirest_tpu_torch.models.layers import merge_heads, split_heads
from hirest_tpu_torch.ops.attention import _softmax_attention_f32, _tma_view

F32_TOL = 1e-5  # chip_smoke.py's bar for the f32 body
KEY_TILE = 32  # keys a tile of the body's online softmax


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to tf32 as cvt.rna.tf32.f32 rounds it: to 10 mantissa
    bits, ties away from zero (the magnitude's bits plus half an ulp,
    then cut)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on f32 inputs as the body's wgmma products take it: 3xTF32
    (passes=3: lo hi' + hi lo' + hi hi') or one TF32 pass (hi hi'), the
    terms summed in f64 and rounded once to f32."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = al.double() @ bh.double() + ah.double() @ bl.double() + out
    return out.float()


def _tf32x3_attention(q, k, v, scale, key_mask=None, passes=3):
    """The body's arithmetic on f32 q [B, H, Sq, D], k/v [B, H, Sk, D]:
    scores in `passes` TF32 passes times scale (f32), masked keys -1e30,
    a running (max, sum) and output rescaled one 32-key tile at a time
    (exp in f32), each tile's PV in `passes` passes added to the rescaled
    output, times 1 / sum (rounded) at the end -> [B, H, Sq, D] f32."""
    s = _matmul(q, k.transpose(-1, -2), passes) * scale
    if key_mask is not None:
        s = torch.where((key_mask > 0)[:, None, None, :], s,
                        torch.full_like(s, -1e30))
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, s.shape[-1], KEY_TILE):
        tile = s[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(tile - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _matmul(p, v[..., k0:k0 + KEY_TILE, :], passes)
        m = m_new
    return o * torch.reciprocal(l)


def _f64_attention(q, k, v, scale, key_mask=None):
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    if key_mask is not None:
        s = torch.where((key_mask > 0)[:, None, None, :], s,
                        torch.full_like(s, -1e30))
    return torch.softmax(s, -1) @ v.double()


def _rel_err(got, want) -> float:
    """max |got - want| as a share of max |want|."""
    got, want = (torch.as_tensor(np.array(t, dtype=np.float64))
                 for t in (got, want))
    return ((got - want).abs().max() / want.abs().max()).item()


# case -> (B, H, S, d, n_real): ViT-B/32's heads (K6 in CLIPScore), EVA-g's
# (K1's layout: 264 rows, keys cut to n_real = 257) and the padded head
# width 128 (K7, K1 padded)
CASES = {
    "vit_b32": (2, 12, 50, 64, 0),
    "eva_g_n_real": (2, 16, 264, 88, 257),
    "eva_g_d128": (2, 16, 257, 128, 0),
}


def _qkv(case, seed):
    """An f32 [B, S, 3 H d] projection at chip_smoke.f32_inputs' scale."""
    b, h, s, d, _ = CASES[case]
    return (np.random.default_rng(seed).normal(size=(b, s, 3 * h * d))
            * 0.75).astype(np.float32)


def _heads(qkv: np.ndarray, h: int, n_real: int):
    q, k, v = (split_heads(t, h) for t in torch.from_numpy(qkv).chunk(3, -1))
    n = n_real or q.shape[2]
    return q, k[:, :, :n], v[:, :, :n]


@pytest.mark.parametrize("case", list(CASES))
def test_tf32x3_within_the_bar_of_plain_and_jax(case):
    """The body's 3xTF32 arithmetic within 1e-5 of max |o| of the plain
    f32 version (the card's yardstick) and of the JAX package's f32
    fused_attention_qkv3 (interpret mode, n_real where the case pads)."""
    b, h, s, d, n_real = CASES[case]
    x = _qkv(case, seed=60)
    q, k, v = _heads(x, h, n_real)
    got = _tf32x3_attention(q, k, v, d ** -0.5)
    plain = _softmax_attention_f32(q, k, v, d ** -0.5)
    jax_out = np.asarray(jax_qkv3(jnp.asarray(x), d ** -0.5, h,
                                  n_real=n_real, interpret=True))
    assert got.shape == (b, h, s, d) and bool(got.isfinite().all())
    assert _rel_err(got, plain) <= F32_TOL
    assert _rel_err(merge_heads(got), jax_out) <= F32_TOL
    # the 3xTF32 error itself, against an f64 product: well inside the bar
    assert _rel_err(got, _f64_attention(q, k, v, d ** -0.5)) <= F32_TOL / 4


def test_one_tf32_pass_misses_the_bar():
    """One TF32 pass (hi hi' alone) at EVA-g's d = 88 errs by more than
    1e-5 of max |o| against the f64 product, where three passes stay
    within the bar: why the body takes three."""
    _, h, _, d, n_real = CASES["eva_g_n_real"]
    q, k, v = _heads(_qkv("eva_g_n_real", seed=61), h, n_real)
    exact = _f64_attention(q, k, v, d ** -0.5)
    one = _rel_err(_tf32x3_attention(q, k, v, d ** -0.5, passes=1), exact)
    three = _rel_err(_tf32x3_attention(q, k, v, d ** -0.5), exact)
    assert one > F32_TOL > three


def test_tf32x3_masked_row_within_the_bar():
    """A masked cross-attention shape (K6 with its key mask, [2, 12, 48,
    64] over 20 keys) with batch row 0's first 15 keys valid and batch row
    1's keys all masked (uniform p, as -1e30 gives): within 1e-5 of max
    |o| of the plain version and of JAX's f32 fused_attention (interpret
    mode)."""
    rng = np.random.default_rng(62)
    q = (rng.normal(size=(2, 12, 48, 64)) * 0.75).astype(np.float32)
    k, v = ((rng.normal(size=(2, 12, 20, 64)) * 0.75).astype(np.float32)
            for _ in range(2))
    mask = np.stack([np.arange(20) < 15, np.zeros(20, bool)]).astype(np.int32)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = _tf32x3_attention(tq, tk, tv, 0.125, tm)
    want = jax_fused_attention(*(jnp.asarray(a) for a in (q, k, v)), 0.125,
                               key_mask=jnp.asarray(mask), use_pallas=True,
                               interpret=True)
    assert _rel_err(got, _softmax_attention_f32(tq, tk, tv, 0.125, tm)) \
        <= F32_TOL
    assert _rel_err(got, np.asarray(want)) <= F32_TOL
    torch.testing.assert_close(got[1], tv[1].mean(1, keepdim=True)
                               .expand_as(got[1]), rtol=1e-5, atol=1e-5)


def test_tma_view_keeps_head_views_and_copies_the_rest():
    """The body's TMA maps take the wrappers' head views of a qkv
    projection as they are (no copy); a view whose row stride is not a
    multiple of 4 elements, or a broadcast one, comes back as a contiguous
    copy of the same values."""
    qkv = torch.randn(2, 65, 3 * 16 * 88)
    for t in qkv.chunk(3, -1):
        view = split_heads(t, 16)
        assert _tma_view(view) is view
    odd = torch.randn(2, 65, 3 * 16 * 88 + 1)[..., :16 * 88]
    odd = split_heads(odd, 16)
    broadcast = torch.randn(1, 16, 65, 88).expand(2, 16, 65, 88)
    for view in (odd, broadcast):
        got = _tma_view(view)
        assert got.is_contiguous() and torch.equal(got, view)


def model_errors() -> dict:
    """case -> (one pass, 3xTF32): the model's error against an f64
    product, as a share of max |o|, on the inputs of the tests."""
    errors = {}
    for case, (_, h, _, d, n_real) in CASES.items():
        q, k, v = _heads(_qkv(case, seed=60), h, n_real)
        exact = _f64_attention(q, k, v, d ** -0.5)
        errors[case] = tuple(
            _rel_err(_tf32x3_attention(q, k, v, d ** -0.5, passes=n), exact)
            for n in (1, 3))
    return errors


if __name__ == "__main__":
    for case, (one, three) in model_errors().items():
        print(f"{case} {CASES[case][:4]}: one pass {one:.2e}, "
              f"3xTF32 {three:.2e}")
