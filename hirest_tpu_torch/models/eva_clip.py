"""EVA-CLIP-g vision tower in PyTorch, and its image preprocessing.

Counterpart of hirest_tpu/models/eva_clip.py (EvaVisionTower, CLIP_MEAN,
CLIP_STD, preprocess_image, preprocess_image_u8). Parameter names are the
EVA reference's own (EVA_clip/vit_model.py:248-351), so the `visual.*` part
of `eva_clip_psz14.pt` loads with `load_state_dict` directly.

Its block is the production bf16 block of hirest_tpu/models/eva_scan.py
(the int8 block, models/eva_scan.py::Int8Block, is built from this one):
LayerNorms computed in f32 and cast to the working dtype, the q/v biases
folded into the qkv projection's bias, the batched-heads attention kernel,
and the short erf polynomial for GELU when `fast_gelu` (the default). Its
working dtype is the dtype of the parameters; the output is f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.models.convert import patch_kernel
from hirest_tpu_torch.models.layers import gelu, gelu_bf16_poly
from hirest_tpu_torch.ops.attention import fused_attention_qkv3


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in f32 and cast back to x's dtype
    (eva_scan._ln)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                     norm.bias.float(), norm.eps)
    return y.to(x.dtype)


class Attention(nn.Module):
    """q/v-only-bias self-attention (vit_model.py:78-126)."""

    def __init__(self, width: int, heads: int, head_width: int):
        super().__init__()
        self.heads = heads
        self.scale = head_width ** -0.5
        inner = heads * head_width
        self.qkv = nn.Linear(width, 3 * inner, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(inner))
        self.v_bias = nn.Parameter(torch.zeros(inner))
        self.proj = nn.Linear(inner, width)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        # [q_bias | 0 | v_bias] rides on the projection (eva_scan._bias3)
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = F.linear(h, self.qkv.weight, bias)
        return self.proj(fused_attention_qkv3(qkv, self.scale, self.heads))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)


class Block(nn.Module):
    """BEiT pre-norm block (vit_model.py:153-182)."""

    def __init__(self, cfg: EvaVisionConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.attn = Attention(cfg.width, cfg.num_heads, cfg.head_width)
        self.norm2 = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.mlp = Mlp(cfg.width, cfg.mlp_hidden)

    def forward(self, x: torch.Tensor, fast_gelu: bool) -> torch.Tensor:
        act = gelu_bf16_poly if fast_gelu else gelu
        x = x + self.attn(layer_norm(x, self.norm1))
        h = act(self.mlp.fc1(layer_norm(x, self.norm2)))
        return x + self.mlp.fc2(h)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: EvaVisionConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.width, kernel_size=p, stride=p)


class EvaVisionTower(nn.Module):
    """ViT-g/14 image encoder: [B, 224, 224, 3] (NHWC) -> [B, 1024] f32."""

    def __init__(self, cfg: EvaVisionConfig = EvaVisionConfig(),
                 fast_gelu: bool = True):
        super().__init__()
        self.cfg = cfg
        self.fast_gelu = fast_gelu
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.width))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.head = nn.Linear(cfg.width, cfg.embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, hh, ww, c = images.shape
        p = cfg.patch_size
        grid = cfg.image_size // p
        if not hh == ww == cfg.image_size:
            raise ValueError(f"expected {cfg.image_size}px input, "
                             f"got {hh}x{ww}")
        w = self.patch_embed.proj.weight
        # patchify in (row, col, channel) order and project with one matmul
        x = images.to(w.dtype).reshape(b, grid, p, grid, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, grid * grid, p * p * c)
        x = x @ patch_kernel(w)
        x = x + self.patch_embed.proj.bias
        x = torch.cat([self.cls_token.expand(b, 1, cfg.width), x], 1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x, self.fast_gelu)
        x = layer_norm(x, self.norm)
        return self.head(x[:, 0]).float()


# ---------------------------------------------------------------------------
# Image preprocessing (host-side): the torchvision transform of
# EVA_clip/eva_clip.py:125-153 — resize shorter side to 224 (bicubic),
# center-crop 224, scale to [0,1], normalize with CLIP mean/std.
# ---------------------------------------------------------------------------

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def _resize_center_crop(img, image_size: int):
    from PIL import Image

    if not isinstance(img, Image.Image):
        img = Image.fromarray(np.asarray(img))
    img = img.convert("RGB")
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    return img.crop((left, top, left + image_size, top + image_size))


def preprocess_image(img, image_size: int = 224) -> np.ndarray:
    """PIL image / HxWx3 uint8 array -> [image_size, image_size, 3] float32 (NHWC)."""
    arr = np.asarray(_resize_center_crop(img, image_size),
                     dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def preprocess_image_u8(img, image_size: int = 224) -> np.ndarray:
    """Resize + center-crop only -> [image_size, image_size, 3] uint8, for
    forwards built with uint8_input=True (eva_scan.fold_uint8_frontend)."""
    return np.asarray(_resize_center_crop(img, image_size), dtype=np.uint8)
