"""The port's OpenAI CLIP towers (hirest_tpu_torch.models.openai_clip),
its ModifiedResNet tower (models/clip_resnet.py) and their converters
against the JAX package's: the same seeded reference-named state dicts
loaded into both, f32 within 1e-5 of the output's largest magnitude, bf16
within 2^-7 of it (every parameter cast, as the port's towers are)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (CLIP_TEXT_TINY, CLIP_VISION_TINY,
                             clip_state_dict, images, text_ids)

from hirest_tpu.config import EvaTextConfig as JaxTextConfig
from hirest_tpu.models import clip_resnet as jax_resnet
from hirest_tpu.models import openai_clip as jax_clip
from hirest_tpu.models.layers import quick_gelu as jax_quick_gelu
from hirest_tpu_torch.config import EvaTextConfig
from hirest_tpu_torch.models.clip_resnet import (RN50, ClipResNetConfig,
                                                 ClipResNetTower)
from hirest_tpu_torch.models.convert import (clip_from_jax,
                                             clip_resnet_from_jax)
from hirest_tpu_torch.models.eva_clip import staged
from hirest_tpu_torch.models.layers import quick_gelu
from hirest_tpu_torch.utils.init import random_clip_state_dict
from hirest_tpu_torch.models.openai_clip import (ClipVisionConfig,
                                                 build_clip_from_state_dict,
                                                 load_clip_towers)

CPU = torch.device("cpu")
F32_TOL = 1e-5  # of the largest |value|
BF16_TOL = 2 ** -7
TEXT_CFG = EvaTextConfig(**CLIP_TEXT_TINY)
VISION_CFG = ClipVisionConfig(**CLIP_VISION_TINY)
JAX_TEXT_CFG = JaxTextConfig(**CLIP_TEXT_TINY)
JAX_VISION_CFG = jax_clip.ClipVisionConfig(**CLIP_VISION_TINY)
# tests/test_clip_resnet.py's tiny ResNet
RESNET_TINY = dict(layers=(1, 1, 1, 1), output_dim=24, heads=2,
                   image_size=64, width=16)


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _jax_towers(sd, text_cfg, vision_cfg, dtype, pool=True):
    tp = {"params": jax_clip.convert_clip_text(sd, text_cfg)}
    vp = {"params": jax_clip.convert_clip_vision(sd, vision_cfg)}
    if dtype != jnp.float32:
        tp, vp = _cast(tp, dtype), _cast(vp, dtype)
    text = jax_clip.ClipTextTower(text_cfg, dtype=dtype)
    vision = jax_clip.ClipVisionTower(vision_cfg, dtype=dtype, pool=pool)
    return (lambda ids: np.asarray(text.apply(tp, jnp.asarray(ids))),
            lambda im: np.asarray(vision.apply(vp, jnp.asarray(im))))


def test_quick_gelu_matches_jax():
    x = np.random.default_rng(0).normal(size=(4, 257)).astype(np.float32) * 4
    close(quick_gelu(torch.from_numpy(x)).numpy(),
          np.asarray(jax_quick_gelu(jnp.asarray(x))), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [True, False])
def test_clip_towers_match_jax(dtype, pool):
    """ClipTextTower and ClipVisionTower (pool True: the class token; False:
    every patch token) at a tiny size, f32 and bf16."""
    sd = clip_state_dict(CLIP_TEXT_TINY, CLIP_VISION_TINY)
    tdt, jdt, tol = ((torch.float32, jnp.float32, F32_TOL)
                     if dtype == "float32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    text, vision = load_clip_towers(sd, device="cpu", dtype=tdt,
                                    text_cfg=TEXT_CFG, vision_cfg=VISION_CFG,
                                    pool=pool)
    jtext, jvision = _jax_towers(sd, JAX_TEXT_CFG, JAX_VISION_CFG, jdt, pool)
    ids = text_ids(CLIP_TEXT_TINY, 4, seed=1)
    im = images(CLIP_VISION_TINY, 3, seed=2)
    with torch.inference_mode():
        got_t = text(torch.from_numpy(ids))
        got_v = vision(torch.from_numpy(im))
    assert got_t.dtype == got_v.dtype == torch.float32
    close(got_t.numpy(), jtext(ids), tol)
    close(got_v.numpy(), jvision(im), tol)
    want_shape = (3, 32) if pool else (3, VISION_CFG.num_patches, 32)
    assert tuple(got_v.shape) == want_shape


def test_clip_b32_width_matches_jax():
    """ViT-B/32 at its own width (text 12 x 512, vision 12 x 768 on
    224 px, 7 x 7 patches of 32) in f32, on the seeded checkpoint at the
    init's own scale. (The tiny tests scale the qkv projections up 4x; at
    this width that gives scores of order 10, where JAX's q * scale before
    the product and K6's scaling of the f32 scores after it, a few f32
    roundings apart, are amplified by the peaked softmax over 12 layers to
    ~4e-5 of the output.)"""
    sd = random_clip_state_dict()
    text, vision = load_clip_towers(sd, device="cpu")
    jtext, jvision = _jax_towers(sd, jax_clip.CLIP_B32_TEXT,
                                 jax_clip.ClipVisionConfig(), jnp.float32)
    spec = dict(context_length=77, vocab_size=49408, image_size=224)
    ids, im = text_ids(spec, 2, seed=3), images(spec, 2, seed=4)
    with torch.inference_mode():
        close(text(torch.from_numpy(ids)).numpy(), jtext(ids), F32_TOL)
        close(vision(torch.from_numpy(im)).numpy(), jvision(im), F32_TOL)


def _resnet_state_dict(cfg: ClipResNetConfig, seed: int = 0) -> dict:
    """Reference-named ResNet tower state dict with random weights and
    random BatchNorm running statistics (tests/test_clip_resnet.py:43-53),
    float32 numpy, under `visual.`."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in ClipResNetTower(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("running_var"):
            a = rng.random(shape, dtype=np.float32) + 0.5
        elif k.endswith("running_mean"):
            a = rng.standard_normal(shape, dtype=np.float32) * 0.1
        else:
            a = rng.standard_normal(shape, dtype=np.float32) * 0.05
        sd[f"visual.{k}"] = a
    return sd


def test_resnet_matches_jax():
    """ClipResNetTower at tests/test_clip_resnet.py's tiny config with
    random running statistics: torch's eval BatchNorm against the JAX
    converter's folded affine, f32."""
    cfg = ClipResNetConfig(**RESNET_TINY)
    sd = _resnet_state_dict(cfg)
    jcfg = jax_resnet.ClipResNetConfig(**RESNET_TINY)
    params = jax_resnet.convert_clip_resnet(sd, jcfg)
    im = images(dict(image_size=64), 3, seed=5)
    want = np.asarray(jax_resnet.ClipResNetTower(jcfg).apply(
        {"params": params}, jnp.asarray(im)))
    tower = staged(ClipResNetTower, cfg,
                   {k[len("visual."):]: torch.from_numpy(v)
                    for k, v in sd.items()}, "ResNet", CPU, torch.float32)
    with torch.inference_mode():
        got = tower(torch.from_numpy(im)).numpy()
    assert got.shape == (3, 24)
    close(got, want, F32_TOL)
    # and back from the JAX tree: the folded affine as a BatchNorm
    back = staged(ClipResNetTower, cfg, clip_resnet_from_jax(params), "ResNet",
                  CPU, torch.float32)
    with torch.inference_mode():
        close(back(torch.from_numpy(im)).numpy(), want, F32_TOL)


def test_rn50_shapes_build():
    """RN50's tower builds, takes 224 px and gives [B, 1024]; every
    parameter the JAX converter reads has the shape the flax tower
    declares."""
    with torch.device("meta"):
        tower = ClipResNetTower(RN50)
        out = tower(torch.zeros(2, 224, 224, 3))
        shapes = {k: tuple(v.shape) for k, v in tower.state_dict().items()}
    assert tuple(out.shape) == (2, RN50.output_dim)
    sd = {k: np.zeros(s, np.float32) + (1.0 if k.endswith("running_var")
                                         else 0.0)
          for k, s in shapes.items()}
    params = jax_resnet.convert_clip_resnet(sd, jax_resnet.RN50)
    want = jax.eval_shape(
        lambda: jax_resnet.ClipResNetTower(jax_resnet.RN50).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))["params"]
    got = jax.tree_util.tree_map(lambda a: a.shape, params)
    assert got == jax.tree_util.tree_map(lambda a: a.shape, want)


@pytest.mark.parametrize("variant", ["vit", "resnet"])
def test_build_clip_from_state_dict_matches_jax(variant):
    """The shape-sniffing factory on a ViT and a ResNet checkpoint: the
    same towers (the ViT's all-token head) and logit scale as JAX's."""
    sd = clip_state_dict(CLIP_TEXT_TINY, CLIP_VISION_TINY)
    if variant == "resnet":
        sd = {k: v for k, v in sd.items() if not k.startswith("visual.")}
        sd.update(_resnet_state_dict(ClipResNetConfig(**RESNET_TINY)))
    vision, text, scale = build_clip_from_state_dict(sd, device="cpu")
    jv, jvp, jt, jtp, jscale = jax_clip.build_clip_from_state_dict(sd)
    assert scale == jscale
    ids = text_ids(CLIP_TEXT_TINY, 3, seed=6)
    im = images(dict(image_size=64), 2, seed=7)
    with torch.inference_mode():
        close(text(torch.from_numpy(ids)).numpy(),
              np.asarray(jt.apply({"params": jtp}, jnp.asarray(ids))),
              F32_TOL)
        got = vision(torch.from_numpy(im)).numpy()
    close(got, np.asarray(jv.apply({"params": jvp}, jnp.asarray(im))),
          F32_TOL)
    assert got.shape == ((2, 16, 32) if variant == "vit" else (2, 24))


def test_clip_from_jax_round_trip():
    """JAX CLIP parameter trees -> clip_from_jax -> the port's towers give
    the JAX towers' outputs; the logit scale survives."""
    sd = clip_state_dict(CLIP_TEXT_TINY, CLIP_VISION_TINY, seed=8)
    tp = jax_clip.convert_clip_text(sd, JAX_TEXT_CFG)
    vp = jax_clip.convert_clip_vision(sd, JAX_VISION_CFG)
    back = clip_from_jax({"params": tp}, vp, logit_scale=100.0)
    assert set(back) == set(sd)
    text, vision = load_clip_towers(back, device="cpu", text_cfg=TEXT_CFG,
                                    vision_cfg=VISION_CFG)
    jtext, jvision = _jax_towers(sd, JAX_TEXT_CFG, JAX_VISION_CFG,
                                 jnp.float32)
    ids, im = text_ids(CLIP_TEXT_TINY, 2, seed=9), images(
        CLIP_VISION_TINY, 2, seed=10)
    with torch.inference_mode():
        close(text(torch.from_numpy(ids)).numpy(), jtext(ids), F32_TOL)
        close(vision(torch.from_numpy(im)).numpy(), jvision(im), F32_TOL)
    assert abs(float(torch.exp(back["logit_scale"])) - 100.0) < 1e-4
