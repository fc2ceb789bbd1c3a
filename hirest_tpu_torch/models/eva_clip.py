"""EVA-CLIP-g towers in PyTorch, their image preprocessing and the model
factory.

Counterpart of hirest_tpu/models/eva_clip.py. Parameter names are the EVA
reference's own (EVA_clip/vit_model.py:248-351 for `visual.*`,
EVA_clip/eva_model.py:177-250 for `text.*`), so the two parts of
`eva_clip_psz14.pt` load with `load_state_dict` directly.

- `EvaVisionTower` (with `Block`) is the bf16 tower of
  hirest_tpu/models/eva_scan.py (the int8 block, models/eva_scan.py::
  Int8Block, is built from this one): LayerNorms computed in f32 and cast
  to the working dtype (or through `ln_bf16`, K10, with `fused_ln`), the
  attention that `BlockOptions.attn` selects (`scanned_attention`: K8,
  K9 or K1), and the short erf polynomial for GELU when `fast_gelu`. The
  options are set once when the forward is built and passed to every
  block. Its working dtype is the dtype of the parameters; the output is
  f32.
- `UnrolledEvaVisionTower` (with `VisionBlock`) is the JAX package's flax
  `EvaVisionTower` with `use_pallas=True` (the factory's `scan=False`), on
  the same state dict: flax's LayerNorm arithmetic (`layer_norm_fast_var`),
  the q/v biases added after the split, exact-erf GELU, and the
  split-heads attention kernel (K6), or the packed one (K7) once the heads
  are padded to 128 (models/eva_pad.py).
- `EvaTextTower` (with `TextBlock`) is the flax `EvaTextTower`.
- `build_eva_model_and_transforms` is the factory
  `build_eva_model_and_transforms` (reference EVA_clip/eva_clip.py:155-171).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hirest_tpu_torch.config import EvaTextConfig, EvaVisionConfig
from hirest_tpu_torch.models.convert import (eva_text_state_dict,
                                             eva_vision_state_dict,
                                             load_into, load_torch_ckpt,
                                             patch_kernel)
from hirest_tpu_torch.models.layers import (MultiHeadAttention, causal_mask,
                                            gelu, gelu_bf16_poly,
                                            layer_norm_fast_var, merge_heads,
                                            split_heads)
from hirest_tpu_torch.ops.attention import (fused_attention,
                                            fused_attention_qkv,
                                            fused_attention_qkv2,
                                            fused_attention_qkv3)
from hirest_tpu_torch.ops.quant import act_quant, ln_bf16
from hirest_tpu_torch.utils.device import resolve_device

ATTENTIONS = ("v1", "v2", "v3", "split")


@dataclass(frozen=True)
class BlockOptions:
    """The kernel flags of the scanned forward, resolved once by
    models/eva_scan.py::build_scanned_vision_apply and handed to every
    block's forward (the defaults are the JAX forward's).

    attn: "v1" (K8: the q/v biases added in the kernel), "v2" (K9) or
    "v3" (K1/K3), both with the biases folded into the qkv projection, or
    "split", the JAX forward's path for head rows that are not 128-wide
    multiples (biases added after the split, K6).
    fused_ln: the bf16 block's LayerNorms through `ln_bf16` (K10).
    fused_quant, fused_mlp: the int8 block's quantizing kernels (K2, K5)
    and the one-kernel MLP (K4); see models/eva_scan.py::Int8Block."""

    fast_gelu: bool = True
    attn: str = "v1"
    fused_ln: bool = False
    fused_quant: bool = False
    fused_mlp: bool = False

    def __post_init__(self):
        if self.attn not in ATTENTIONS:
            raise ValueError(f"attn must be one of {ATTENTIONS}, got "
                             f"{self.attn!r}")


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in f32 and cast back to x's dtype
    (eva_scan._ln)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                     norm.bias.float(), norm.eps)
    return y.to(x.dtype)


def linear(h: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h @ weight^T + bias as eva_scan writes it (`h @ w + b`): the product
    rounded to h's dtype, then the bias added in that dtype. F.linear with
    a bias would round product and bias once, which in bf16 is another
    number."""
    y = F.linear(h, weight)
    return y if bias is None else y.add_(bias)


def fused_layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """`layer_norm`'s function through `ln_bf16` (K10)."""
    return ln_bf16(x, norm.weight, norm.bias, norm.eps)


def scanned_attention(qkv: torch.Tensor, q_bias: torch.Tensor,
                      v_bias: torch.Tensor, scale: float, heads: int,
                      attn: str, *, quant_out: bool = False):
    """The scanned block's attention on its qkv projection [B, S, 3*H*d],
    as eva_scan.py:390-430 dispatches it: "v3" and "v2" take qkv with the
    q/v biases already added (K1/K3, K9), "v1" adds them in the kernel
    (K8), "split" adds them in qkv's dtype and runs K6 on the split heads.
    Returns [B, S, H*d], or with quant_out its int8 codes and f32 row
    scales [B, S, 1]: the kernels' epilogue, or for "split" act_quant
    (K5) on the output, as the JAX forward quantizes it."""
    if attn == "v3":
        return fused_attention_qkv3(qkv, scale, heads, quant_out=quant_out)
    if attn == "v2":
        return fused_attention_qkv2(qkv, scale, heads, quant_out=quant_out)
    if attn == "v1":
        return fused_attention_qkv(qkv, q_bias, v_bias, scale, heads,
                                   quant_out=quant_out)
    q, k, v = qkv.chunk(3, -1)
    q, v = q + q_bias.to(qkv.dtype), v + v_bias.to(qkv.dtype)
    out = merge_heads(fused_attention(split_heads(q, heads),
                                      split_heads(k, heads),
                                      split_heads(v, heads), scale))
    return act_quant(out.contiguous(), act="none") if quant_out else out


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

    def forward(self, h: torch.Tensor, attn: str) -> torch.Tensor:
        bias = None
        if attn in ("v2", "v3"):
            # [q_bias | 0 | v_bias] rides on the projection (eva_scan._bias3)
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
        qkv = linear(h, self.qkv.weight, bias)
        return linear(scanned_attention(qkv, self.q_bias, self.v_bias,
                                        self.scale, self.heads, attn),
                      self.proj.weight, self.proj.bias)


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

    def forward(self, x: torch.Tensor, opts: BlockOptions) -> torch.Tensor:
        act = gelu_bf16_poly if opts.fast_gelu else gelu
        ln = fused_layer_norm if opts.fused_ln else layer_norm
        x = x + self.attn(ln(x, self.norm1), opts.attn)
        h = act(linear(ln(x, self.norm2), self.mlp.fc1.weight,
                       self.mlp.fc1.bias))
        return x + linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: EvaVisionConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.width, kernel_size=p, stride=p)


class EvaVisionTower(nn.Module):
    """ViT-g/14 image encoder: [B, 224, 224, 3] (NHWC) -> [B, 1024] f32."""

    block = Block

    def __init__(self, cfg: EvaVisionConfig = EvaVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.width))
        self.blocks = nn.ModuleList(self.block(cfg) for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.head = nn.Linear(cfg.width, cfg.embed_dim)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Patch embedding, class token and positions: -> [B, 1 + N, width]
        in the working dtype."""
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
        return x + self.pos_embed

    def forward(self, images: torch.Tensor,
                opts: BlockOptions = BlockOptions()) -> torch.Tensor:
        x = self.embed(images)
        for blk in self.blocks:
            x = blk(x, opts)
        x = layer_norm(x, self.norm)
        return linear(x[:, 0], self.head.weight, self.head.bias).float()


class VisionBlock(nn.Module):
    """The flax VisionBlock: BEiT pre-norm block with q/v-only bias
    attention (vit_model.py:153-182), on `Block`'s parameter names."""

    def __init__(self, cfg: EvaVisionConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.attn = MultiHeadAttention(cfg.width, cfg.num_heads,
                                       cfg.head_width, mode="fused_qv_bias")
        self.norm2 = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.mlp = Mlp(cfg.width, cfg.mlp_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm_fast_var(x, self.norm1))
        h = gelu(self.mlp.fc1(layer_norm_fast_var(x, self.norm2)))
        return x + self.mlp.fc2(h)


class UnrolledEvaVisionTower(EvaVisionTower):
    """The flax EvaVisionTower(use_pallas=True): `EvaVisionTower`'s state
    dict and patch embedding, `VisionBlock`s, and the final LayerNorm in
    the working dtype. [B, 224, 224, 3] (NHWC) -> [B, 1024] f32."""

    block = VisionBlock

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.embed(images)
        for blk in self.blocks:
            x = blk(x)
        x = layer_norm_fast_var(x, self.norm)
        return self.head(x[:, 0]).float()


class TextMlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)


class TextBlock(nn.Module):
    """Pre-LN residual attention block (eva_model.py:110-159)."""

    def __init__(self, cfg: EvaTextConfig, mlp_ratio: float = 4.0):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.attn = MultiHeadAttention(cfg.width, cfg.heads,
                                       cfg.width // cfg.heads, mode="fused")
        self.ln_2 = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.mlp = TextMlp(cfg.width, int(cfg.width * mlp_ratio))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm_fast_var(x, self.ln_1), bias)
        h = gelu(self.mlp.c_fc(layer_norm_fast_var(x, self.ln_2)))
        return x + self.mlp.c_proj(h)


class EvaTextTower(nn.Module):
    """CLIP text encoder: token ids [B, T <= 77] -> [B, 1024] f32, in the
    working dtype of its parameters."""

    def __init__(self, cfg: EvaTextConfig = EvaTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.width))
        self.transformer = nn.ModuleDict({"resblocks": nn.ModuleList(
            TextBlock(cfg) for _ in range(cfg.layers))})
        self.ln_final = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.text_projection = nn.Parameter(
            torch.zeros(cfg.width, cfg.embed_dim))

    def forward(self, text_ids: torch.Tensor) -> torch.Tensor:
        ids = text_ids.long()
        t = ids.shape[1]
        x = self.token_embedding(ids) + self.positional_embedding[:t]
        bias = causal_mask(t, device=x.device)
        for blk in self.transformer["resblocks"]:
            x = blk(x, bias)
        x = layer_norm_fast_var(x, self.ln_final)
        # EOT pooling: the EOT token has the highest id in each row
        x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(-1)]
        return (x @ self.text_projection).float()


def staged(cls, cfg, sd: Mapping, what: str, device: torch.device,
           dtype: torch.dtype) -> nn.Module:
    """`cls(cfg)` with the state dict `sd` loaded (every key it needs, or
    KeyError), on `device` in `dtype`, in eval mode. Built on the meta
    device, so no parameter is allocated twice."""
    with torch.device("meta"):
        module = cls(cfg)
    return load_into(module, sd, what).to(device=device, dtype=dtype).eval()


def build_unrolled_vision_apply(params: Mapping,
                                cfg: EvaVisionConfig = EvaVisionConfig(), *,
                                dtype: torch.dtype = torch.bfloat16,
                                device=None):
    """Stage `UnrolledEvaVisionTower` on `device` with every parameter in
    `dtype` (as the JAX factory casts them) and return
    `apply(images [B, H, W, 3] NHWC) -> [B, embed_dim] f32`. params: an EVA
    vision state dict, `visual.`-prefixed or bare."""
    device = resolve_device(device)
    tower = staged(UnrolledEvaVisionTower, cfg, eva_vision_state_dict(params),
                   "EVA vision", device, dtype)

    @torch.inference_mode()
    def apply(images) -> torch.Tensor:
        return tower(torch.as_tensor(images).to(device))

    return apply


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


def eva_text_encoder(sd: Mapping, text_cfg: EvaTextConfig,
                     dtype: torch.dtype, device: torch.device):
    """Stage the text tower of `sd` (`text.`-prefixed or bare keys) on
    `device` in `dtype`; returns `encode_text(ids [B, <=77]) -> [B, 1024]`
    f32 on the device."""
    tower = staged(EvaTextTower, text_cfg, eva_text_state_dict(sd),
                   "EVA text", device, dtype)

    @torch.inference_mode()
    def encode_text(ids) -> torch.Tensor:
        return tower(torch.as_tensor(ids).to(device))

    return encode_text


def build_eva_model_and_transforms(
        model_name: str = "EVA_CLIP_g_14",
        pretrained: Union[str, Mapping, None] = None,
        dtype: torch.dtype = torch.bfloat16, padded_heads: bool = False,
        scan: bool = True, int8: bool = False,
        text_config: Optional[EvaTextConfig] = None,
        vision_config: Optional[EvaVisionConfig] = None, device=None):
    """The reference's factory surface (EVA_clip/eva_clip.py:155-171) on
    `device` (CUDA unless "cpu" is asked for): returns (model, preprocess)
    where `model.encode_text(ids [B, <=77]) -> [B, 1024]` and
    `model.encode_image(images NHWC) -> [B, 1024]`, both f32 on the device;
    `model.vision_config` is the vision tower's config (padded or not).

    pretrained: the torch `eva_clip_psz14.pt` checkpoint (its `text.*` and
    `visual.*` keys), or such a state dict already loaded; without one the
    towers get seeded random weights (loudly).
    padded_heads: pad the vision heads 88 -> 128 (models/eva_pad.py), an
    identity on the outputs.
    scan: True is the production forward (build_scanned_vision_apply with
    attn_v3 and, with int8, fused_quant and fused_mlp, as the JAX factory
    passes them: K1, or with int8 K2-K4); False the unrolled tower (K6, or
    K7 with padded heads), which ignores int8 as the JAX factory does. The
    JAX factory's `use_pallas` has no counterpart: a CUDA tensor always
    takes the kernels, a CPU tensor their plain versions."""
    from hirest_tpu_torch.models.eva_pad import pad_vision_head_params
    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
    from hirest_tpu_torch.utils.init import (random_eva_text_state_dict,
                                             random_eva_vision_state_dict)

    if model_name != "EVA_CLIP_g_14":
        raise ValueError(f"unknown model {model_name}")
    device = resolve_device(device)  # before building a 1B-parameter tower
    text_cfg = text_config or EvaTextConfig()
    vision_cfg = vision_config or EvaVisionConfig()
    if isinstance(pretrained, Mapping):
        sd = pretrained
    elif pretrained and os.path.exists(pretrained):
        sd = load_torch_ckpt(pretrained)
        print(f"Loaded EVA CLIP G from {pretrained}")
    else:
        sd = {**{f"text.{k}": v for k, v in
                 random_eva_text_state_dict(text_cfg, seed=0).items()},
              **{f"visual.{k}": v for k, v in
                 random_eva_vision_state_dict(vision_cfg, seed=0).items()}}
        print(f"WARNING: {pretrained!r} not found - EVA towers are "
              f"random-init")
    vision_sd = eva_vision_state_dict(sd)
    if padded_heads:
        vision_sd, vision_cfg = pad_vision_head_params(vision_sd, vision_cfg)
    if scan:
        encode_image = build_scanned_vision_apply(
            vision_sd, vision_cfg, dtype=dtype, int8=int8, attn_v3=True,
            fused_quant=int8, fused_mlp=int8, device=device)
    else:
        encode_image = build_unrolled_vision_apply(
            vision_sd, vision_cfg, dtype=dtype, device=device)

    model = SimpleNamespace(
        encode_text=eva_text_encoder(sd, text_cfg, dtype, device),
        encode_image=encode_image, vision_config=vision_cfg)
    return model, preprocess_image
