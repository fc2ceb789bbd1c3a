"""Model architecture configs of the port.

Own copies of `EvaVisionConfig` and `EvaTextConfig` from
hirest_tpu/config.py (the port imports nothing of the JAX package). Field
names and defaults are the same, so one set of values describes the same
tower in both packages. `heads_override` is set by the padded-heads
transform (models/eva_pad.py), which widens each head and keeps the count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class EvaVisionConfig:
    """EVA-CLIP-g vision tower (reference EVA_clip/model_configs/EVA_CLIP_g_14.json)."""

    image_size: int = 224
    layers: int = 40
    width: int = 1408
    head_width: int = 88
    mlp_ratio: float = 4.3637
    patch_size: int = 14
    embed_dim: int = 1024  # output projection dim
    norm_eps: float = 1e-6
    heads_override: Optional[int] = None  # set when head_width is padded

    @property
    def num_heads(self) -> int:
        if self.heads_override is not None:
            return self.heads_override
        return self.width // self.head_width

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


@dataclass(frozen=True)
class EvaTextConfig:
    """EVA-CLIP-g text tower (reference EVA_clip/eva_model.py:177-250)."""

    context_length: int = 77
    vocab_size: int = 49408
    width: int = 768
    heads: int = 12
    layers: int = 12
    embed_dim: int = 1024
    norm_eps: float = 1e-5
