"""Model architecture configs of the port.

An own copy of `EvaVisionConfig` from hirest_tpu/config.py (the port imports
nothing of the JAX package). Field names and defaults are the same, so one
set of values describes the same tower in both packages; `heads_override`,
which only the JAX package's padded-heads variant sets, is not carried.
"""

from __future__ import annotations

from dataclasses import dataclass


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

    @property
    def num_heads(self) -> int:
        return self.width // self.head_width

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)
