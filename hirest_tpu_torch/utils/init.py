"""Seeded random weights for when no checkpoint is present.

Values come from one `numpy.random.default_rng(seed)` stream at about the
scale of the JAX package's `shape_only_init` (0.02); LayerNorm weights sit
near 1. The tower-wide tensors are drawn first and the blocks after them in
order, so a config with fewer layers gets the same weights as the first
blocks of a deeper one (a depth-cut run checks the full model's weights).
Key names are the EVA reference's, without the `visual.` or `text.` prefix,
and the joint checkpoint's for `random_moment_state_dict`.
"""

from __future__ import annotations

import numpy as np
import torch

from hirest_tpu_torch.config import (EvaTextConfig, EvaVisionConfig,
                                     JointModelConfig)

SCALE = 0.02


def eva_vision_shapes(cfg: EvaVisionConfig) -> dict:
    """Reference key -> shape of every EVA vision-tower tensor, tower-wide
    tensors first, then blocks 0..layers-1."""
    w, p, inner = cfg.width, cfg.patch_size, cfg.num_heads * cfg.head_width
    shapes = {
        "patch_embed.proj.weight": (w, 3, p, p),
        "patch_embed.proj.bias": (w,),
        "cls_token": (1, 1, w),
        "pos_embed": (1, cfg.num_patches + 1, w),
        "norm.weight": (w,),
        "norm.bias": (w,),
        "head.weight": (cfg.embed_dim, w),
        "head.bias": (cfg.embed_dim,),
    }
    for i in range(cfg.layers):
        r = f"blocks.{i}"
        shapes.update({
            f"{r}.norm1.weight": (w,),
            f"{r}.norm1.bias": (w,),
            f"{r}.attn.qkv.weight": (3 * inner, w),
            f"{r}.attn.q_bias": (inner,),
            f"{r}.attn.v_bias": (inner,),
            f"{r}.attn.proj.weight": (w, inner),
            f"{r}.attn.proj.bias": (w,),
            f"{r}.norm2.weight": (w,),
            f"{r}.norm2.bias": (w,),
            f"{r}.mlp.fc1.weight": (cfg.mlp_hidden, w),
            f"{r}.mlp.fc1.bias": (cfg.mlp_hidden,),
            f"{r}.mlp.fc2.weight": (w, cfg.mlp_hidden),
            f"{r}.mlp.fc2.bias": (w,),
        })
    return shapes


def eva_text_shapes(cfg: EvaTextConfig) -> dict:
    """Reference key -> shape of every EVA text-tower tensor, tower-wide
    tensors first, then blocks 0..layers-1."""
    w, hidden = cfg.width, 4 * cfg.width
    shapes = {
        "token_embedding.weight": (cfg.vocab_size, w),
        "positional_embedding": (cfg.context_length, w),
        "ln_final.weight": (w,),
        "ln_final.bias": (w,),
        "text_projection": (w, cfg.embed_dim),
    }
    for i in range(cfg.layers):
        r = f"transformer.resblocks.{i}"
        shapes.update({
            f"{r}.ln_1.weight": (w,),
            f"{r}.ln_1.bias": (w,),
            f"{r}.attn.in_proj_weight": (3 * w, w),
            f"{r}.attn.in_proj_bias": (3 * w,),
            f"{r}.attn.out_proj.weight": (w, w),
            f"{r}.attn.out_proj.bias": (w,),
            f"{r}.ln_2.weight": (w,),
            f"{r}.ln_2.bias": (w,),
            f"{r}.mlp.c_fc.weight": (hidden, w),
            f"{r}.mlp.c_fc.bias": (hidden,),
            f"{r}.mlp.c_proj.weight": (w, hidden),
            f"{r}.mlp.c_proj.bias": (w,),
        })
    return shapes


def _draw(shapes: dict, seed: int, norm_keys: tuple) -> dict:
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in shapes.items():
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= SCALE
        if key.endswith(norm_keys):
            a += 1.0
        sd[key] = a
    return sd


def random_eva_vision_state_dict(cfg: EvaVisionConfig = EvaVisionConfig(),
                                 seed: int = 0) -> dict:
    """Reference-named EVA vision state dict of float32 numpy arrays."""
    return _draw(eva_vision_shapes(cfg), seed,
                 ("norm.weight", "norm1.weight", "norm2.weight"))


def random_eva_text_state_dict(cfg: EvaTextConfig = EvaTextConfig(),
                               seed: int = 0) -> dict:
    """Reference-named EVA text state dict of float32 numpy arrays."""
    return _draw(eva_text_shapes(cfg), seed,
                 ("ln_1.weight", "ln_2.weight", "ln_final.weight"))


def random_moment_state_dict(cfg: JointModelConfig = JointModelConfig(),
                             seed: int = 0) -> dict:
    """Reference-named joint (MomentModel) state dict of float32 numpy
    arrays, drawn in the module's own key order; LayerNorm weights near 1."""
    from hirest_tpu_torch.models.joint import MomentModel

    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in MomentModel(cfg).state_dict().items()}
    return _draw(shapes, seed, ("LayerNorm.weight", "visual_norm2d.weight",
                                "asr_enc_layer.0.weight"))
