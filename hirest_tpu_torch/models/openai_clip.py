"""OpenAI CLIP ViT-B/32 in PyTorch: the reference's alternate retrieval
backbone (`--video_retrieval_model clip`) and the CLIPScore model of
step-captioning evaluation.

Counterpart of hirest_tpu/models/openai_clip.py (reference
EVA_clip/model.py:140-276, the vendored OpenAI CLIP): pre-LN transformer
blocks with QuickGELU (`eva_clip.TextBlock(act="quick_gelu")`), a vision
tower with class embedding, ln_pre/ln_post and a [width, embed]
projection, and a text tower shaped as the EVA one at width 512, 8 heads.

Parameters carry the OpenAI state dict's own names (`conv1.weight`,
`class_embedding`, `transformer.resblocks.N.attn.in_proj_weight`, ...;
the vision tower's under `visual.` in the checkpoint), so `ViT-B-32.pt`
loads with `load_state_dict`. The patch embedding runs as the JAX tower's
patchify-and-matmul, on conv1's kernel flattened in (row, col, channel)
order (`convert.patch_kernel`); the LayerNorms are flax's arithmetic
(`layer_norm_fast_var`). The text tower's attention is causal, so plain;
the vision tower's has no bias and goes to the split-heads kernel (K6, or
its f32 body in f32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
from torch import nn

from hirest_tpu_torch.config import EvaTextConfig
from hirest_tpu_torch.models.convert import (_f32, _sub_state_dict,
                                             patch_kernel)
from hirest_tpu_torch.models.eva_clip import EvaTextTower, TextBlock, staged
from hirest_tpu_torch.models.layers import layer_norm_fast_var
from hirest_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ClipVisionConfig:
    """ViT-B/32 defaults."""

    image_size: int = 224
    layers: int = 12
    width: int = 768
    heads: int = 12
    patch_size: int = 32
    embed_dim: int = 512
    norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_B32_TEXT = EvaTextConfig(context_length=77, vocab_size=49408, width=512,
                              heads=8, layers=12, embed_dim=512)


class ClipTextTower(EvaTextTower):
    """OpenAI CLIP text encoder: ids [B, <= 77] -> [B, embed_dim] f32; EOT
    pooling at the argmax id, causal attention, QuickGELU."""

    def __init__(self, cfg: EvaTextConfig = CLIP_B32_TEXT):
        super().__init__(cfg, act="quick_gelu")


class ClipVisionTower(nn.Module):
    """ViT-B/32 image encoder: [B, 224, 224, 3] (NHWC) -> [B, embed_dim] f32.

    pool=True is the standard OpenAI CLIP head (ln_post on the class token,
    then the projection; `clip.load("ViT-B/32")`,
    inference_video_retrieval.py:169). pool=False is the vendored
    EVA-modified variant (EVA_clip/model.py:252-272): ln_post and the
    projection on every patch token -> [B, grid^2, embed_dim]."""

    def __init__(self, cfg: ClipVisionConfig = ClipVisionConfig(),
                 pool: bool = True):
        super().__init__()
        self.cfg, self.pool = cfg, pool
        w, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Conv2d(3, w, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, w))
        self.ln_pre = nn.LayerNorm(w, eps=cfg.norm_eps)
        self.transformer = nn.ModuleDict({"resblocks": nn.ModuleList(
            TextBlock(cfg, act="quick_gelu") for _ in range(cfg.layers))})
        self.ln_post = nn.LayerNorm(w, eps=cfg.norm_eps)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, hh, ww, c = images.shape
        p = cfg.patch_size
        grid = cfg.image_size // p
        if not hh == ww == cfg.image_size:
            raise ValueError(f"expected {cfg.image_size}px input, "
                             f"got {hh}x{ww}")
        w = self.conv1.weight
        # patchify in (row, col, channel) order; conv1 has no bias
        x = images.to(w.dtype).reshape(b, grid, p, grid, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, grid * grid, p * p * c)
        x = x @ patch_kernel(w)
        cls = self.class_embedding.expand(b, 1, cfg.width)
        x = torch.cat([cls, x], 1) + self.positional_embedding
        x = layer_norm_fast_var(x, self.ln_pre)
        for blk in self.transformer["resblocks"]:
            x = blk(x, None)
        x = x[:, 0] if self.pool else x[:, 1:]
        x = layer_norm_fast_var(x, self.ln_post)
        return (x @ self.proj).float()


def clip_vision_state_dict(sd: Mapping) -> dict:
    """The `visual.*` keys of an OpenAI CLIP state dict, without the
    prefix, as f32 tensors."""
    return _sub_state_dict(sd, "visual.")


def clip_text_state_dict(sd: Mapping) -> dict:
    """The text tower's (top-level, non-`visual.`) keys as f32 tensors."""
    return {k: _f32(v) for k, v in sd.items() if not k.startswith("visual.")}


def load_clip_towers(sd: Mapping, device=None, dtype=torch.float32,
                     text_cfg: EvaTextConfig = CLIP_B32_TEXT,
                     vision_cfg: ClipVisionConfig = ClipVisionConfig(),
                     pool: bool = True):
    """(ClipTextTower, ClipVisionTower) of an OpenAI CLIP state dict, in
    eval mode on `device` (CUDA unless "cpu" is asked for) in `dtype`."""
    device = resolve_device(device)
    text = staged(ClipTextTower, text_cfg, clip_text_state_dict(sd),
                  "CLIP text", device, dtype)
    vision = staged(lambda c: ClipVisionTower(c, pool=pool), vision_cfg,
                    clip_vision_state_dict(sd), "CLIP vision", device, dtype)
    return text, vision


def build_clip_from_state_dict(sd: Mapping, device=None):
    """Shape-sniffing factory after the reference `build_model`
    (EVA_clip/model.py:433-471): infers the variant (VisionTransformer or
    ModifiedResNet, the text dims) from the checkpoint's shapes and returns
    `(vision_tower, text_tower, logit_scale)`, the towers loaded in f32, in
    eval mode on `device` (CUDA unless "cpu" is asked for). The ViT
    is the vendored surface's all-tokens variant (pool=False), as the JAX
    function builds it. Takes torch tensors or numpy arrays."""
    device = resolve_device(device)

    def shape(k):
        return tuple(sd[k].shape)

    visual = clip_vision_state_dict(sd)
    if "visual.proj" in sd:  # ViT
        width = shape("visual.conv1.weight")[0]
        patch = shape("visual.conv1.weight")[-1]
        grid = round((shape("visual.positional_embedding")[0] - 1) ** 0.5)
        layers = len([k for k in sd if k.startswith("visual.")
                      and k.endswith(".attn.in_proj_weight")])
        vcfg = ClipVisionConfig(image_size=patch * grid, layers=layers,
                                width=width, heads=width // 64,
                                patch_size=patch,
                                embed_dim=shape("visual.proj")[1])
        vision = staged(lambda c: ClipVisionTower(c, pool=False), vcfg,
                        visual, "CLIP vision", device, torch.float32)
    else:  # ModifiedResNet
        from hirest_tpu_torch.models.clip_resnet import (ClipResNetConfig,
                                                         ClipResNetTower)

        counts = tuple(
            len({k.split(".")[2] for k in sd
                 if k.startswith(f"visual.layer{b}.")}) for b in (1, 2, 3, 4))
        width = shape("visual.layer1.0.conv1.weight")[0]
        out_grid = round(
            (shape("visual.attnpool.positional_embedding")[0] - 1) ** 0.5)
        rcfg = ClipResNetConfig(
            layers=counts, output_dim=shape("visual.attnpool.c_proj.weight")[0],
            heads=width * 32 // 64, image_size=out_grid * 32, width=width)
        vision = staged(ClipResNetTower, rcfg, visual, "CLIP ResNet", device,
                        torch.float32)

    tcfg = EvaTextConfig(
        context_length=shape("positional_embedding")[0],
        vocab_size=shape("token_embedding.weight")[0],
        width=shape("ln_final.weight")[0],
        heads=shape("ln_final.weight")[0] // 64,
        layers=len({k.split(".")[2] for k in sd
                    if k.startswith("transformer.resblocks")}),
        embed_dim=shape("text_projection")[1])
    text = staged(ClipTextTower, tcfg, clip_text_state_dict(sd), "CLIP text",
                  device, torch.float32)
    ls = sd["logit_scale"]
    ls = ls.detach().cpu().numpy() if isinstance(ls, torch.Tensor) else ls
    return vision, text, float(np.exp(np.asarray(ls)))
