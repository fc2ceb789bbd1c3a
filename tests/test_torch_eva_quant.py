"""The unrolled int8 EVA vision tower of the PyTorch port against JAX.

hirest_tpu_torch/models/eva_quant.py::build_int8_vision_apply against
hirest_tpu/models/eva_quant.py::build_int8_vision_apply on one seeded
state dict, in f32 on the CPU, at the config of
tests/test_pallas_attention.py::test_int8_vision_tower_close_to_float
(patch 14, so the patch embedding's K is 588, and B <= 16: the two
shapes `torch._int_mm` refuses on the card unpadded). The JAX side runs
its K6 Pallas kernel with interpret=True, as that test does; the port's
wrapper takes its plain version on CPU tensors.

Bar: within 1e-3 of the output's largest magnitude and cosine >= 0.9999.
Both sides quantize the same f32 activations, but the two frameworks'
f32 LayerNorm and softmax differ in the last bits, which can move an
activation across a code boundary: one code of 127 is 4e-3 of a row's
range, and a 2-layer tower averages such steps out to below 1e-3.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hirest_tpu.ops.attention as jax_attention
from hirest_tpu.models.eva_clip import EvaVisionTower as JaxEvaVisionTower
from hirest_tpu.models.eva_quant import \
    build_int8_vision_apply as jax_build_int8
from hirest_tpu_torch.models.eva_clip import build_unrolled_vision_apply
from hirest_tpu_torch.models.eva_quant import build_int8_vision_apply
from hirest_tpu_torch.ops.quant import (QuantDense, dyn_quant_rows, int8_mm,
                                        int8_matmul, quantize_weight)
from tests.torch_port_util import (configs, cosine, eva_state_dict, images,
                                   jax_params)

# tests/test_pallas_attention.py:151
SPEC = dict(image_size=28, patch_size=14, layers=2, width=32, head_width=8,
            mlp_ratio=2.0, embed_dim=16)
TOL, COS = 1e-3, 0.9999


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = jax_attention._pallas_attention
    monkeypatch.setattr(
        jax_attention, "_pallas_attention",
        lambda q, k, v, s, **kw: orig(q, k, v, s,
                                      **{**kw, "interpret": True}))


@pytest.mark.parametrize("quant_attention", [True, False])
@pytest.mark.parametrize("batch", [2, 20])
def test_int8_tower_matches_jax(interpret_pallas, quant_attention, batch):
    jcfg, cfg = configs(SPEC)
    sd = eva_state_dict(SPEC, seed=3)
    imgs = images(SPEC, batch, seed=4)
    want = np.asarray(jax_build_int8(jax_params(sd, SPEC), jcfg,
                                     quant_attention=quant_attention,
                                     dtype=jnp.float32)(jnp.asarray(imgs)))
    got = build_int8_vision_apply(sd, cfg, quant_attention=quant_attention,
                                  dtype=torch.float32,
                                  device="cpu")(imgs).numpy()
    assert got.shape == want.shape == (batch, SPEC["embed_dim"])
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err
    assert cosine(got, want).min() >= COS


def test_int8_tower_close_to_float():
    """The port's int8 tower against its own float unrolled tower, at the
    JAX test's bar (cosine > 0.99)."""
    _, cfg = configs(SPEC)
    sd = eva_state_dict(SPEC, seed=5)
    imgs = images(SPEC, 4, seed=6)
    want = build_unrolled_vision_apply(sd, cfg, dtype=torch.float32,
                                       device="cpu")(imgs).numpy()
    for quant_attention in (True, False):
        got = build_int8_vision_apply(sd, cfg, quant_attention=quant_attention,
                                      dtype=torch.float32,
                                      device="cpu")(imgs).numpy()
        assert cosine(got, want).min() > 0.99


@pytest.mark.parametrize("m,k", [(2, 588), (16, 588), (17, 592), (3, 64)])
def test_int8_matmul_padding_changes_nothing(m, k):
    """int8_matmul pads K to a multiple of 8 and the rows to 17 for the
    card; the result equals the unpadded product bit for bit."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(24, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(24,)).astype(np.float32))
    dense = QuantDense(w, b, torch.float32)
    assert dense.w_q.shape == (24, -(-k // 8) * 8)
    w_q, w_s = quantize_weight(w)
    x_q, x_s = dyn_quant_rows(x)
    want = int8_mm(x_q, x_s, w_q, w_s, b, torch.float32)
    got = dense(x)
    assert torch.equal(got, want)
    assert torch.equal(int8_matmul(x[None], dense.w_q, dense.w_s, b,
                                   torch.float32)[0], want)
