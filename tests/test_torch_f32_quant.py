"""The int8-out attention forms (K3, K9 int8, K8 int8) on f32 activations,
the f32 int8 factory's inputs, on the CPU.

On the card an f32 tensor in `fused_attention_qkv3/qkv2/qkv(quant_out=True)`
launches attention_f32.cu's body with the int8 epilogue; here the wrappers
take their plain versions, which are held against the JAX Pallas kernels
(interpret mode) on f32 input at a small size, and the CUDA body's
arithmetic (64-key tiles, an online softmax in f32 with the divide after
PV, then one scale a row over all heads) is emulated in PyTorch and held
against the plain version at the card's bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import assert_codes_close

from hirest_tpu.ops.attention import fused_attention_qkv as jax_qkv1
from hirest_tpu.ops.attention import fused_attention_qkv2 as jax_qkv2
from hirest_tpu.ops.attention import fused_attention_qkv3 as jax_qkv3
from hirest_tpu_torch.models.layers import merge_heads, split_heads
from hirest_tpu_torch.ops.attention import (fused_attention_qkv,
                                            fused_attention_qkv2,
                                            fused_attention_qkv3,
                                            fused_attention_qkv_ref,
                                            fused_attention_qkv3_ref)
from hirest_tpu_torch.ops.quant import dyn_quant_rows

B, S, N_REAL, H, D = 2, 24, 17, 4, 32  # small: 24 tokens, 17 real


def _inputs(seed: int, s: int = S, h: int = H, d: int = D):
    rng = np.random.default_rng(seed)
    qkv = (rng.normal(size=(B, s, 3 * h * d)) * 0.5).astype(np.float32)
    qb, vb = (rng.normal(size=h * d).astype(np.float32) * 0.5
              for _ in range(2))
    return qkv, qb, vb


FORMS = {  # form -> (port wrapper call, JAX kernel call) on (qkv, qb, vb)
    "K3": (lambda x, qb, vb: fused_attention_qkv3(
        x, D ** -0.5, H, quant_out=True, n_real=N_REAL),
        lambda x, qb, vb: jax_qkv3(x, D ** -0.5, H, interpret=True,
                                   quant_out=True, n_real=N_REAL)),
    "K9": (lambda x, qb, vb: fused_attention_qkv2(
        x, D ** -0.5, H, quant_out=True, n_real=N_REAL),
        lambda x, qb, vb: jax_qkv2(x, D ** -0.5, H, interpret=True,
                                   quant_out=True, n_real=N_REAL)),
    "K8": (lambda x, qb, vb: fused_attention_qkv(
        x, qb, vb, D ** -0.5, H, quant_out=True),
        lambda x, qb, vb: jax_qkv1(x, qb, vb, D ** -0.5, H, interpret=True,
                                   quant_out=True)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_f32_quant_out_plain_matches_jax(form):
    """f32 in, int8 codes and f32 row scales out: the plain version against
    the JAX kernel on the same f32 input (K3/K9 with pad keys masked, K8
    with nonzero biases); scales within 2e-5, codes within one and equal on
    99.9 % (the f32 bars of tests/test_torch_attention.py)."""
    port, jax_fn = FORMS[form]
    x, qb, vb = _inputs(seed=ord(form[1]))
    q, s = port(*(torch.from_numpy(a) for a in (x, qb, vb)))
    jq, js = jax_fn(*(jnp.asarray(a) for a in (x, qb, vb)))
    assert q.dtype == torch.int8 and q.shape == (B, S, H * D)
    assert s.dtype == torch.float32 and s.shape == (B, S, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-5)
    assert_codes_close(q.numpy(), np.asarray(jq), 0.999)


def _f32_body(q, k, v, scale: float, key_tile: int = 64):
    """attention_f32.cu's arithmetic: per 64-key tile, scaled f32 scores,
    the running max and sum (exp(m_old - m_new) rescaling), f32 PV, and
    the divide after the last tile. q [B, H, Sq, d], k/v [B, H, Sk, d]."""
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    lsum = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], key_tile):
        s = (q @ k[:, :, k0:k0 + key_tile].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ v[:, :, k0:k0 + key_tile]
        m = m_new
    return acc / lsum


@pytest.mark.parametrize("form", ["K3", "K8"])
def test_f32_body_with_epilogue_within_the_card_bar(form):
    """The CUDA body's arithmetic with the int8 epilogue (y never rounded,
    one scale a row over all 16 heads) against the plain version at EVA-g's
    [2, 264, 3 * 16 * 88] (K3: 257 real keys, K8: biased, all 264): codes
    within one and equal on 99 %, scales within 2**-7, K3's card bars in
    chip_smoke.py's check_codes."""
    h, d = 16, 88
    x, qb, vb = _inputs(seed=5, s=264, h=h, d=d)
    t, tqb, tvb = (torch.from_numpy(a) for a in (x, qb, vb))
    q, k, v = (split_heads(c, h) for c in t.chunk(3, -1))
    if form == "K3":
        got = dyn_quant_rows(merge_heads(_f32_body(
            q, k[:, :, :257], v[:, :, :257], d ** -0.5)))
        want = fused_attention_qkv3_ref(t, d ** -0.5, h, quant_out=True,
                                        n_real=257)
    else:
        q = q + split_heads(tqb.expand(1, 1, -1), h)
        v = v + split_heads(tvb.expand(1, 1, -1), h)
        got = dyn_quant_rows(merge_heads(_f32_body(q, k, v, d ** -0.5)))
        want = fused_attention_qkv_ref(t, tqb, tvb, d ** -0.5, h,
                                       quant_out=True)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(),
                               rtol=2 ** -7)
    assert_codes_close(got[0].numpy(), want[0].numpy(), 0.99)


def test_f32_quant_cpu_calls_count_nothing():
    """On the CPU the f32 int8-out calls take the plain versions and count
    no launch, bf16 or f32."""
    from hirest_tpu_torch.ops import attention

    wrappers = (attention.fused_attention_qkv3, attention.fused_attention_qkv2,
                attention.fused_attention_qkv)
    attrs = ("launches", "quant_launches", "launches_f32",
             "quant_launches_f32")
    before = [getattr(w, a) for w in wrappers for a in attrs]
    x, qb, vb = _inputs(seed=7)
    for form, (port, _) in FORMS.items():
        port(*(torch.from_numpy(a) for a in (x, qb, vb)))
    assert [getattr(w, a) for w in wrappers for a in attrs] == before
