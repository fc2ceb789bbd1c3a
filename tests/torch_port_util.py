"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py).

One place builds the seeded EVA vision and text state dicts that every port
test loads into both packages: reference key names, so the port loads them
directly and the JAX package maps them with `convert_eva_vision` and
`convert_eva_text`.
"""

from __future__ import annotations

import numpy as np

from hirest_tpu.config import EvaTextConfig as JaxEvaTextConfig
from hirest_tpu.config import EvaVisionConfig as JaxEvaVisionConfig
from hirest_tpu.models.convert import convert_eva_text, convert_eva_vision
from hirest_tpu_torch.config import EvaTextConfig, EvaVisionConfig
from hirest_tpu_torch.utils.init import (random_eva_text_state_dict,
                                         random_eva_vision_state_dict)

# the tiny configs of tests/test_eva_scan.py: TINY (64 wide, the flax
# tower's unpacked attention) and PACKED (128 wide, the width at which the
# JAX forward takes its v3 Pallas kernel)
TINY = dict(image_size=28, layers=3, width=64, head_width=16, mlp_ratio=4.0,
            patch_size=14, embed_dim=32)
PACKED = dict(image_size=28, layers=3, width=128, head_width=32,
              mlp_ratio=4.0, patch_size=14, embed_dim=32)
# 224 px input (what preprocess_image makes) on a 4x4 patch grid
TINY224 = dict(image_size=224, layers=2, width=128, head_width=32,
               mlp_ratio=4.0, patch_size=56, embed_dim=32)

# random_eva_vision_state_dict draws at 0.02; at these small widths that
# leaves the softmax nearly uniform, so the tests scale the qkv projection
# up to give scores of order one and exercise the attention for real
QKV_GAIN = 4.0


# a small text tower: 2 layers, 4 heads of 16, context 16, vocab 100
TEXT_TINY = dict(context_length=16, vocab_size=100, width=64, heads=4,
                 layers=2, embed_dim=32)


def configs(spec: dict):
    """(JAX config, port config) for one spec."""
    return JaxEvaVisionConfig(**spec), EvaVisionConfig(**spec)


def eva_state_dict(spec: dict, seed: int = 0) -> dict:
    """Seeded reference-named EVA vision state dict (float32 numpy)."""
    sd = random_eva_vision_state_dict(EvaVisionConfig(**spec), seed=seed)
    for k in sd:
        if k.endswith("attn.qkv.weight"):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
    return sd


def jax_params(sd: dict, spec: dict) -> dict:
    return {"params": convert_eva_vision(sd, JaxEvaVisionConfig(**spec))}


def text_configs(spec: dict):
    """(JAX text config, port text config) for one spec."""
    return JaxEvaTextConfig(**spec), EvaTextConfig(**spec)


def text_state_dict(spec: dict, seed: int = 0) -> dict:
    """Seeded reference-named EVA text state dict (float32 numpy), the qkv
    projection scaled up as the vision one is."""
    sd = random_eva_text_state_dict(EvaTextConfig(**spec), seed=seed)
    for k in sd:
        if k.endswith("attn.in_proj_weight"):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
    return sd


def jax_text_params(sd: dict, spec: dict) -> dict:
    return {"params": convert_eva_text(sd, JaxEvaTextConfig(**spec))}


def text_ids(spec: dict, n: int, seed: int = 0) -> np.ndarray:
    """Token ids [n, context] as a tokenizer gives them: tokens below the
    EOT id (the vocabulary's last), EOT at varied positions, zeros after."""
    ctx, eot = spec["context_length"], spec["vocab_size"] - 1
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, eot, size=(n, ctx))
    ends = rng.integers(1, ctx, size=n)
    ends[0] = ctx - 1
    for row, end in zip(ids, ends):
        row[end] = eot
        row[end + 1:] = 0
    return ids.astype(np.int32)


def images(spec: dict, n: int, seed: int = 0) -> np.ndarray:
    """Normalised-scale NHWC float32 images."""
    s = spec["image_size"]
    return np.random.default_rng(seed).normal(
        size=(n, s, s, 3)).astype(np.float32)


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def assert_codes_close(got, want, min_equal: float) -> None:
    """int8 codes within one of each other, and equal on a share of at
    least min_equal of them: an f32 rounding that differs lands a value on
    the other side of a code boundary."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= min_equal, (diff == 0).mean()
