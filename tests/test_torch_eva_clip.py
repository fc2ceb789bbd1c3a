"""The port's EVA-CLIP model factory and the towers it assembles
(hirest_tpu_torch.models.eva_clip, eva_pad, convert) against the JAX
package: the text tower, the unrolled vision tower on split-heads (K6) and
packed-heads (K7) attention, the padded-heads transform and the padded
scanned forward. Seeded state dicts (tests/torch_port_util.py) are loaded
into both packages; JAX runs its Pallas kernels in interpret mode, the
port its plain versions on the CPU."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (PACKED, TEXT_TINY, TINY, configs, cosine,
                             eva_state_dict, images, jax_params,
                             jax_text_params, text_configs, text_ids,
                             text_state_dict)

import hirest_tpu.models.convert as jax_convert
from hirest_tpu.models.eva_clip import EvaTextTower as FlaxEvaTextTower
from hirest_tpu.models.eva_clip import EvaVisionTower as FlaxEvaVisionTower
from hirest_tpu.models.eva_clip import \
    build_eva_model_and_transforms as jax_factory
from hirest_tpu.models.eva_pad import \
    pad_vision_head_params as jax_pad_vision_head_params
from hirest_tpu.models.eva_scan import \
    build_scanned_vision_apply as jax_build
from hirest_tpu.models.layers import causal_mask as jax_causal_mask
from hirest_tpu.models.layers import \
    dot_product_attention as jax_dot_product_attention
from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.models.convert import (eva_text_from_jax,
                                             eva_text_state_dict,
                                             eva_vision_from_jax)
from hirest_tpu_torch.models.eva_clip import (EvaTextTower,
                                              build_eva_model_and_transforms,
                                              build_unrolled_vision_apply,
                                              staged)
from hirest_tpu_torch.models.eva_pad import pad_vision_head_params
from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
from hirest_tpu_torch.models.layers import causal_mask, dot_product_attention
from hirest_tpu_torch.utils.init import random_eva_text_state_dict

# the JAX package's production int8 configuration (fq+v3+flat+tp+fm)
JAX_INT8 = dict(int8=True, fused_quant=True, attn_v3=True, flat2d=True,
                pad_tokens=True, fused_mlp=True)


def _text_tower(sd, dtype=torch.float32):
    return staged(EvaTextTower, text_configs(TEXT_TINY)[1],
                  eva_text_state_dict(sd), "EVA text", torch.device("cpu"),
                  dtype)


def _jax_text(sd, ids, dtype=jnp.float32):
    params = jax_text_params(sd, TEXT_TINY)
    if dtype != jnp.float32:  # the JAX factory casts every parameter
        params = {"params": {k: _cast(v, dtype)
                             for k, v in params["params"].items()}}
    return np.asarray(FlaxEvaTextTower(text_configs(TEXT_TINY)[0],
                                       dtype=dtype).apply(
        params, jnp.asarray(ids)).astype(jnp.float32))


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return jnp.asarray(tree, dtype)


# --- the text tower --------------------------------------------------------


def test_text_convert_round_trip_is_exact():
    sd = text_state_dict(TEXT_TINY)
    back = eva_text_from_jax(jax_text_params(sd, TEXT_TINY))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], torch.from_numpy(v)), k
    # and the port's tower takes it by the reference's names, strictly
    EvaTextTower(text_configs(TEXT_TINY)[1]).load_state_dict(back,
                                                             strict=True)


def test_text_tower_matches_flax_f32():
    """f32 against the flax EvaTextTower at 1e-4, the JAX package's
    scan-vs-unrolled bar (test_eva_scan.py:37); EOT pooling at varied
    positions."""
    sd, ids = text_state_dict(TEXT_TINY, seed=1), text_ids(TEXT_TINY, 6)
    want = _jax_text(sd, ids)
    with torch.inference_mode():
        got = _text_tower(sd)(torch.from_numpy(ids)).numpy()
    assert got.shape == (6, TEXT_TINY["embed_dim"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_text_tower_bf16_close_to_flax():
    """bf16 at cosine > 0.99 against the flax tower in bf16 (every
    parameter cast, as the JAX factory does) and in f32."""
    sd, ids = text_state_dict(TEXT_TINY, seed=2), text_ids(TEXT_TINY, 6, 2)
    with torch.inference_mode():
        got = _text_tower(sd, torch.bfloat16)(torch.from_numpy(ids)).numpy()
    assert np.all(cosine(got, _jax_text(sd, ids, jnp.bfloat16)) > 0.99)
    assert np.all(cosine(got, _jax_text(sd, ids)) > 0.99)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_attention_matches_jax(dtype):
    """The plain biased attention of the text tower: f32 at 1e-6; bf16
    within one bf16 ulp of the output's largest magnitude."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
               for _ in range(3))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_dot_product_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jax_causal_mask(9), 0.25,
        dtype=jdt).astype(jnp.float32))
    got = dot_product_attention(*(torch.from_numpy(a).to(tdt)
                                  for a in (q, k, v)), causal_mask(9), 0.25)
    assert got.dtype == tdt
    np.testing.assert_array_equal(causal_mask(9).numpy(),
                                  np.asarray(jax_causal_mask(9)))
    atol = 1e-6 if dtype == "float32" else 2.0 ** (
        np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_random_text_init_is_depth_prefix_stable():
    deep = random_eva_text_state_dict(text_configs(TEXT_TINY)[1], seed=4)
    shallow = random_eva_text_state_dict(
        text_configs({**TEXT_TINY, "layers": 1})[1], seed=4)
    assert set(shallow) < set(deep)
    for k, v in shallow.items():
        np.testing.assert_array_equal(v, deep[k])


# --- the unrolled vision tower (K6) ---------------------------------------


def _flax_tower(sd, spec, cfg=None, params=None, dtype=jnp.float32):
    cfg = cfg or configs(spec)[0]
    return FlaxEvaVisionTower(cfg, use_pallas=True, interpret=True,
                              dtype=dtype).apply(params or
                                                 jax_params(sd, spec),
                                                 jnp.asarray(images(spec, 3)))


@pytest.mark.parametrize("spec", [TINY, PACKED], ids=["tiny", "packed"])
def test_unrolled_tower_matches_flax_pallas(spec):
    """f32 against the flax EvaVisionTower(use_pallas=True) with K6 in
    interpret mode at 1e-4 (test_eva_scan.py:37)."""
    sd = eva_state_dict(spec, seed=5)
    want = np.asarray(_flax_tower(sd, spec))
    got = build_unrolled_vision_apply(sd, configs(spec)[1],
                                      dtype=torch.float32,
                                      device="cpu")(images(spec, 3)).numpy()
    assert got.shape == (3, spec["embed_dim"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_unrolled_bf16_close_to_flax():
    """bf16 (every parameter cast) at cosine > 0.99 against the flax tower
    in bf16 and in f32."""
    sd = eva_state_dict(PACKED, seed=6)
    got = build_unrolled_vision_apply(sd, configs(PACKED)[1],
                                      device="cpu")(images(PACKED, 3))
    assert got.dtype == torch.float32
    bf16 = np.asarray(_flax_tower(
        sd, PACKED, params=_cast(jax_params(sd, PACKED), jnp.bfloat16),
        dtype=jnp.bfloat16)).astype(np.float32)
    assert np.all(cosine(got.numpy(), bf16) > 0.99)
    assert np.all(cosine(got.numpy(), np.asarray(_flax_tower(sd, PACKED)))
                  > 0.99)


# --- padded heads (K7, and K1/K3 at head width 128) -----------------------


def _padded(spec, seed):
    sd = eva_state_dict(spec, seed=seed)
    psd, pcfg = pad_vision_head_params(sd, configs(spec)[1])
    jparams, jcfg = jax_pad_vision_head_params(jax_params(sd, spec),
                                               configs(spec)[0])
    return sd, psd, pcfg, jparams, jcfg


def test_pad_matches_jax_transform():
    """The port's padding of a state dict is the JAX padding of the same
    weights, mapped back with eva_vision_from_jax, bit for bit; the config
    keeps the head count."""
    sd, psd, pcfg, jparams, jcfg = _padded(PACKED, seed=7)
    want = eva_vision_from_jax(jparams)
    assert psd.keys() == want.keys()
    for k in want:
        assert torch.equal(psd[k], want[k]), k
    assert (pcfg.head_width, pcfg.heads_override, pcfg.num_heads) == (
        128, 4, 4) == (jcfg.head_width, jcfg.heads_override, jcfg.num_heads)
    assert psd["blocks.0.attn.qkv.weight"].shape == (3 * 4 * 128, 128)
    assert sd["blocks.0.attn.qkv.weight"].shape == (3 * 128, 128)  # unchanged
    full = pad_vision_head_params({}, EvaVisionConfig(layers=0))[1]
    assert (full.num_heads, full.head_width) == (16, 128)


def test_padded_unrolled_matches_jax_and_unpadded():
    """The padded unrolled tower (K7 path at head width 128) against the
    flax tower on JAX's padded weights (K7 in interpret mode), and against
    the unpadded tower (the transform is an identity), both within 2e-5 in
    f32."""
    sd, psd, pcfg, jparams, jcfg = _padded(TINY, seed=8)
    got = build_unrolled_vision_apply(psd, pcfg, dtype=torch.float32,
                                      device="cpu")(images(TINY, 3)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(_flax_tower(sd, TINY, cfg=jcfg, params=jparams)),
        rtol=2e-5, atol=2e-5)
    unpadded = build_unrolled_vision_apply(sd, configs(TINY)[1],
                                           dtype=torch.float32,
                                           device="cpu")(images(TINY, 3))
    np.testing.assert_allclose(got, unpadded.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["float", "bf16", "int8"])
def test_padded_scanned_matches_jax(mode):
    """The padded scanned forward (K1, or K2-K4 with int8, at head width
    128) against JAX build_scanned_vision_apply on its padded weights with
    attn_v3 in interpret mode, at test_torch_eva.py's bars: f32 2e-4, bf16
    cosine > 0.99 against the f32 JAX forward, int8 (f32) 2e-3 against the
    JAX int8 production forward."""
    sd, psd, pcfg, jparams, jcfg = _padded(PACKED, seed=9)
    im = images(PACKED, 4, seed=9)
    flags = JAX_INT8 if mode == "int8" else dict(attn_v3=True)
    want = np.asarray(jax_build(jparams, jcfg, use_pallas=True,
                                interpret=True, dtype=jnp.float32,
                                **flags)(jnp.asarray(im)))
    int8 = mode == "int8"
    got = build_scanned_vision_apply(
        psd, pcfg, device="cpu", int8=int8, attn_v3=True, fused_quant=int8,
        fused_mlp=int8,
        dtype=torch.bfloat16 if mode == "bf16" else torch.float32)(im)
    got = got.numpy()
    if mode == "bf16":
        assert np.all(cosine(got, want) > 0.99)
    else:
        tol = 2e-3 if mode == "int8" else 2e-4
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# --- the factory ------------------------------------------------------------


@pytest.fixture
def checkpoint(tmp_path, monkeypatch):
    """One `eva_clip_psz14.pt`-style checkpoint of small towers (`text.*`
    and `visual.*`), and the JAX converters bound to the small configs (the
    JAX factory converts with the full-size defaults)."""
    sd = {**{f"text.{k}": torch.from_numpy(v)
             for k, v in text_state_dict(TEXT_TINY, seed=10).items()},
          **{f"visual.{k}": torch.from_numpy(v)
             for k, v in eva_state_dict(TINY, seed=10).items()}}
    path = tmp_path / "eva_clip_psz14.pt"
    torch.save(sd, path)
    monkeypatch.setattr(jax_convert, "convert_eva_text", functools.partial(
        jax_convert.convert_eva_text, config=text_configs(TEXT_TINY)[0]))
    monkeypatch.setattr(jax_convert, "convert_eva_vision", functools.partial(
        jax_convert.convert_eva_vision, config=configs(TINY)[0]))
    return str(path)


def _factories(path, **kw):
    jax_model, _ = jax_factory(pretrained=path, dtype=jnp.float32,
                               text_config=text_configs(TEXT_TINY)[0],
                               vision_config=configs(TINY)[0], **kw)
    model, pre = build_eva_model_and_transforms(
        pretrained=path, dtype=torch.float32, device="cpu",
        text_config=text_configs(TEXT_TINY)[1],
        vision_config=configs(TINY)[1], **kw)
    return jax_model, model, pre


def test_factory_encode_text_matches_jax_factory(checkpoint):
    """encode_text of the two factories on one checkpoint, f32, at 1e-4."""
    jax_model, model, pre = _factories(checkpoint)
    ids = text_ids(TEXT_TINY, 5, seed=11)
    got = model.encode_text(ids)
    assert got.dtype == torch.float32 and got.shape == (5, 32)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_model.encode_text(ids)),
                               rtol=1e-4, atol=1e-4)
    assert pre(np.zeros((30, 40, 3), np.uint8)).shape == (224, 224, 3)


@pytest.mark.parametrize("scan,padded_heads,int8", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, False), (True, True, True)],
    ids=["unrolled", "padded_unrolled", "scanned", "padded_scanned",
         "padded_scanned_int8"])
def test_factory_encode_image_matches_jax_modules(checkpoint, scan,
                                                  padded_heads, int8):
    """encode_image against the JAX modules the JAX factory assembles from
    the same checkpoint, run as the JAX tests run them (Pallas in
    interpret mode): the unrolled flax tower at 1e-4, the scanned forward
    at 2e-4, the int8 forward at 2e-3 (f32)."""
    jax_model, model, _ = _factories(checkpoint, scan=scan,
                                     padded_heads=padded_heads, int8=int8)
    im = images(TINY, 3, seed=12)
    jcfg = jax_model.vision_tower.config
    if scan:
        flags = JAX_INT8 if int8 else dict(attn_v3=True)
        want = jax_build(jax_model.vision_params, jcfg, use_pallas=True,
                         interpret=True, dtype=jnp.float32,
                         **flags)(jnp.asarray(im))
    else:
        want = jax_model.vision_tower.clone(interpret=True).apply(
            jax_model.vision_params, jnp.asarray(im))
    got = model.encode_image(im)
    assert model.vision_config.num_heads == jcfg.num_heads == 4
    assert model.vision_config.head_width == jcfg.head_width
    tol = 2e-3 if int8 else (2e-4 if scan else 1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_factory_without_checkpoint_is_random_and_loud(capsys):
    model, _ = build_eva_model_and_transforms(
        pretrained=None, device="cpu", text_config=text_configs(TEXT_TINY)[1],
        vision_config=configs(TINY)[1], scan=False)
    assert "random-init" in capsys.readouterr().out
    t = model.encode_text(text_ids(TEXT_TINY, 2))
    v = model.encode_image(images(TINY, 2))
    assert t.shape == v.shape == (2, 32) and t.dtype == torch.float32
    assert bool(t.isfinite().all() and v.isfinite().all())
    with pytest.raises(ValueError, match="unknown model"):
        build_eva_model_and_transforms("ViT-B-32", device="cpu")
