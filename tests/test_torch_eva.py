"""The port's EVA-CLIP-g forwards, bf16 and int8 (hirest_tpu_torch.models),
against the JAX package, on one seeded EVA state dict
(tests/torch_port_util.py) loaded into both: directly into the port,
through convert_eva_vision into JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (PACKED, TINY, configs, cosine, eva_state_dict,
                             images, jax_params)

from hirest_tpu.models.convert import convert_eva_vision
from hirest_tpu.models.eva_clip import EvaVisionTower as FlaxEvaVisionTower
from hirest_tpu.models.eva_scan import \
    build_scanned_vision_apply as jax_build
from hirest_tpu.models.eva_scan import fold_uint8_frontend as jax_fold
from hirest_tpu.models.layers import gelu as jax_gelu
from hirest_tpu.models.layers import gelu_bf16_poly as jax_gelu_poly
from hirest_tpu_torch.models.convert import (eva_vision_from_jax,
                                             eva_vision_state_dict,
                                             patch_kernel)
from hirest_tpu_torch.models.eva_clip import (CLIP_MEAN, CLIP_STD,
                                              EvaVisionTower)
from hirest_tpu_torch.models.eva_scan import (Int8Block,
                                              build_scanned_vision_apply,
                                              fold_uint8_frontend)
from hirest_tpu_torch.models.layers import gelu, gelu_bf16_poly
from hirest_tpu_torch.ops.quant import quantize_weight
from hirest_tpu_torch.utils.init import random_eva_vision_state_dict


def _port(sd, spec, **kw):
    _, cfg = configs(spec)
    kw.setdefault("dtype", torch.float32)
    return build_scanned_vision_apply(sd, cfg, device="cpu", **kw)


def test_convert_round_trip_is_exact():
    sd = eva_state_dict(PACKED)
    back = eva_vision_from_jax(jax_params(sd, PACKED))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], torch.from_numpy(v)), k
    # and the port's tower loads it by the reference's names, strictly
    EvaVisionTower(configs(PACKED)[1]).load_state_dict(back, strict=True)


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_forward_matches_jax_v3_forward(fast_gelu):
    """f32 against the JAX production forward (v3 Pallas attention in
    interpret mode) at 2e-4, the JAX package's Pallas-vs-XLA bar
    (test_eva_scan.py:93)."""
    sd, im = eva_state_dict(PACKED), images(PACKED, 4)
    want = np.asarray(jax_build(jax_params(sd, PACKED), configs(PACKED)[0],
                                use_pallas=True, attn_v3=True,
                                interpret=True, dtype=jnp.float32,
                                fast_gelu=fast_gelu)(jnp.asarray(im)))
    got = _port(sd, PACKED, attn_v3=True, fast_gelu=fast_gelu)(im).numpy()
    assert got.shape == (4, PACKED["embed_dim"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_exact_gelu_forward_matches_flax_tower():
    """fast_gelu=False against the unrolled flax EvaVisionTower at the TINY
    config, at 1e-4: the JAX package's scan-vs-unrolled bar
    (test_eva_scan.py:37)."""
    sd, im = eva_state_dict(TINY, seed=1), images(TINY, 3, seed=1)
    want = np.asarray(FlaxEvaVisionTower(configs(TINY)[0]).apply(
        jax_params(sd, TINY), jnp.asarray(im)))
    got = _port(sd, TINY, fast_gelu=False)(im).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_uint8_input_matches_normalized_input():
    """Raw uint8 frames through a uint8_input forward == normalised f32
    frames through the standard one, at 2e-4 (test_eva_scan.py:238); and
    the port's uint8 forward == the JAX package's at the same bar."""
    sd = eva_state_dict(TINY, seed=2)
    u8 = np.random.default_rng(7).integers(0, 256, size=(3, 28, 28, 3),
                                           dtype=np.uint8)
    normalized = ((u8.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD
    want = _port(sd, TINY)(normalized).numpy()
    got = _port(sd, TINY, uint8_input=True)(u8).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    jax_u8 = np.asarray(jax_build(jax_params(sd, TINY), configs(TINY)[0],
                                  use_pallas=False, dtype=jnp.float32,
                                  uint8_input=True)(jnp.asarray(u8)))
    np.testing.assert_allclose(got, jax_u8, rtol=2e-4, atol=2e-4)


def test_fold_uint8_frontend_matches_jax():
    """The fold is f32 arithmetic on the same values: the scaled kernel is
    bit-equal, the folded bias (a 588-term dot) agrees to f32 rounding."""
    sd = random_eva_vision_state_dict(configs(PACKED)[1], seed=3)
    w = patch_kernel(torch.from_numpy(sd["patch_embed.proj.weight"]))
    b = sd["patch_embed.proj.bias"]
    jw, jb = jax_fold(w.numpy(), b)
    tw, tb = fold_uint8_frontend(w, torch.from_numpy(b))
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-6, atol=1e-6)


def test_bf16_forward_close_to_f32_reference():
    """bf16 against the f32 JAX forward at cosine > 0.99
    (test_eva_scan.py:47)."""
    sd, im = eva_state_dict(PACKED, seed=4), images(PACKED, 4, seed=4)
    want = np.asarray(jax_build(jax_params(sd, PACKED), configs(PACKED)[0],
                                use_pallas=True, attn_v3=True,
                                interpret=True,
                                dtype=jnp.float32)(jnp.asarray(im)))
    got = _port(sd, PACKED, attn_v3=True, dtype=torch.bfloat16)(im)
    assert got.dtype == torch.float32
    assert np.all(cosine(got.numpy(), want) > 0.99)


def test_gelu_bf16_poly_is_bit_exact_in_f32():
    x = (np.random.default_rng(5).normal(size=20000) * 4).astype(np.float32)
    x[:4] = [-50.0, -4.1, 0.0, 50.0]
    want = np.asarray(jax_gelu_poly(jnp.asarray(x)))
    got = gelu_bf16_poly(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # and returns the input dtype without touching its input
    xb = torch.from_numpy(x).bfloat16()
    keep = xb.clone()
    assert gelu_bf16_poly(xb).dtype == torch.bfloat16
    assert torch.equal(xb, keep)


def test_exact_gelu_matches_jax():
    x = (np.random.default_rng(6).normal(size=20000) * 4).astype(np.float32)
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_visual_prefixed_checkpoint_loads():
    """A whole-CLIP state dict: `visual.` keys are taken with the prefix
    stripped and the text tower's keys are left out."""
    sd = eva_state_dict(TINY)
    full = {f"visual.{k}": v for k, v in sd.items()}
    full["text.token_embedding.weight"] = np.zeros((4, 8), np.float32)
    got = eva_vision_state_dict(full)
    assert got.keys() == sd.keys()
    im = images(TINY, 2)
    np.testing.assert_array_equal(_port(full, TINY)(im).numpy(),
                                  _port(sd, TINY)(im).numpy())
    # a JAX tree converted back gives the same forward
    back = eva_vision_from_jax(convert_eva_vision(sd, configs(TINY)[0]))
    np.testing.assert_array_equal(_port(back, TINY)(im).numpy(),
                                  _port(sd, TINY)(im).numpy())


def test_missing_weights_raise():
    sd = eva_state_dict(TINY)
    del sd["blocks.1.attn.q_bias"]
    with pytest.raises(KeyError, match="lacks 1 keys"):
        _port(sd, TINY)


def test_random_init_is_depth_prefix_stable():
    """A shallower config draws the same tower-wide tensors and first
    blocks as a deeper one, so a depth-cut run checks the same weights."""
    deep = random_eva_vision_state_dict(configs(TINY)[1], seed=9)
    shallow = random_eva_vision_state_dict(
        configs({**TINY, "layers": 1})[1], seed=9)
    assert set(shallow) < set(deep)
    for k, v in shallow.items():
        np.testing.assert_array_equal(v, deep[k])


# --- the int8 forward ------------------------------------------------------

# wide enough that the MLP (2048 hidden units) has two 1024-unit requant
# chunks, so the per-(row, chunk) scales are exercised
WIDE = dict(image_size=28, layers=2, width=512, head_width=32, mlp_ratio=4.0,
            patch_size=14, embed_dim=32)
# the JAX package's production int8 configuration (fq+v3+flat+tp+fm)
JAX_INT8 = dict(int8=True, fused_quant=True, attn_v3=True, flat2d=True,
                pad_tokens=True, fused_mlp=True, use_pallas=True,
                interpret=True)
# and the port's: the same flags less the TPU layout ones
PORT_INT8 = dict(int8=True, fused_quant=True, attn_v3=True, fused_mlp=True)


def _jax_int8(sd, spec, images_, **kw):
    kw.setdefault("dtype", jnp.float32)
    return np.asarray(jax_build(jax_params(sd, spec), configs(spec)[0],
                                **JAX_INT8, **kw)(jnp.asarray(images_)))


@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("spec", [PACKED, WIDE], ids=["packed", "wide"])
def test_int8_forward_matches_jax(spec, fast_gelu):
    """f32, plain versions of K2-K4, 257-style unpadded tokens, against the
    JAX int8 production forward (Pallas in interpret mode, tokens padded)
    at 2e-3, the JAX package's own fq and fused-MLP bar
    (test_eva_scan.py:111, :216)."""
    sd, im = eva_state_dict(spec, seed=11), images(spec, 4, seed=11)
    want = _jax_int8(sd, spec, im, fast_gelu=fast_gelu)
    got = _port(sd, spec, **PORT_INT8, fast_gelu=fast_gelu)(im).numpy()
    assert got.shape == (4, spec["embed_dim"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_int8_bf16_forward_close_to_jax():
    """bf16 int8 against the f32 JAX int8 forward at cosine > 0.99, and
    within the JAX int8 bar (cosine > 0.98, test_eva_scan.py:57) of the f32
    float forward."""
    sd, im = eva_state_dict(WIDE, seed=12), images(WIDE, 4, seed=12)
    got = _port(sd, WIDE, **PORT_INT8, dtype=torch.bfloat16)(im).numpy()
    assert np.all(cosine(got, _jax_int8(sd, WIDE, im)) > 0.99)
    assert np.all(cosine(got, _port(sd, WIDE)(im).numpy()) > 0.98)


def test_int8_uint8_input_matches_jax():
    """Raw uint8 frames through the port's int8 forward against the JAX
    int8 uint8 forward, cosine > 0.99."""
    sd = eva_state_dict(PACKED, seed=13)
    u8 = np.random.default_rng(13).integers(0, 256, size=(3, 28, 28, 3),
                                            dtype=np.uint8)
    want = _jax_int8(sd, PACKED, u8, uint8_input=True)
    got = _port(sd, PACKED, **PORT_INT8, uint8_input=True)(u8).numpy()
    assert np.all(cosine(got, want) > 0.99)


def test_int8_block_quantizes_the_float_weights():
    """Codes come from the f32 weights, not from weights already rounded to
    the working dtype; biases and norm parameters are rounded to it and
    kept in f32; codes int8, scales f32."""
    tcfg = configs(WIDE)[1]
    tower = EvaVisionTower(tcfg)
    tower.load_state_dict({k: torch.from_numpy(v) for k, v in
                           eva_state_dict(WIDE, seed=14).items()})
    blk = tower.blocks[0]
    ib = Int8Block(blk, torch.bfloat16)
    w = blk.mlp.fc1.weight.detach()
    q, s = quantize_weight(w)
    assert torch.equal(ib.fc1_wq, q) and torch.equal(ib.fc1_ws, s)
    assert not torch.equal(ib.fc1_wq, quantize_weight(w.bfloat16())[0])
    assert ib.qkv_wq.dtype == torch.int8 and ib.qkv_ws.dtype == torch.float32
    assert ib.qkv_wq.shape == blk.attn.qkv.weight.shape
    assert torch.equal(ib.norm1_w,
                       blk.norm1.weight.detach().bfloat16().float())
    assert torch.equal(ib.qkv_b[:tcfg.width],
                       blk.attn.q_bias.detach().bfloat16().float())
    assert not ib.qkv_b[tcfg.width:2 * tcfg.width].any()
