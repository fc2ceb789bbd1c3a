"""The port's K1 attention (hirest_tpu_torch/ops/attention.py) against the
JAX package's fused_attention_qkv3 (Pallas, interpret mode) at the real
EVA-g attention shape [2, 257, 4224], H=16, d=88.

On the CPU the port's wrapper takes its plain version, so these tests hold
the plain version's arithmetic against the TPU kernel's; the CUDA kernel is
held against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hirest_tpu.ops.attention import fused_attention_qkv3 as jax_qkv3
from hirest_tpu_torch.ops.attention import (fused_attention_qkv3,
                                            fused_attention_qkv3_ref)

B, S, H, D = 2, 257, 16, 88
SCALE = D ** -0.5


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
