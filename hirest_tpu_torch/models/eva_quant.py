"""The unrolled int8 forward of the frozen EVA vision tower.

Counterpart of hirest_tpu/models/eva_quant.py::build_int8_vision_apply: a
functional forward over the float tower's state dict in which every dense
layer, the patch embedding and the head included, is an int8 x int8 ->
int32 product (`ops/quant.py::QuantDense`: weights per output channel,
activations per row from f32 by E4, the product and its epilogue, in f32
and then the cast, in G1). With
`quant_attention=False` the qkv and out projections stay in the working
dtype. The rest of the block is the JAX function's: `eva_scan._ln` (f32
statistics, cast back), the q/v biases added in the working dtype after the
split, the split-heads attention kernel (K6, `ops/attention.py::
fused_attention`) and the exact GELU.

G1 reads its operands by TMA, so K must be a multiple of 16: the patch
embedding's K = 14 * 14 * 3 = 588 is zero-padded to 592 (`ops/quant.py::
QuantDense`), which changes no number. G1 takes any number of rows, the
head's B class-token rows included.
"""

from __future__ import annotations

from typing import Mapping

import torch

from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.models.convert import eva_vision_state_dict, patch_kernel
from hirest_tpu_torch.models.eva_clip import linear
from hirest_tpu_torch.models.eva_scan import _ln
from hirest_tpu_torch.models.layers import gelu, merge_heads, split_heads
from hirest_tpu_torch.ops.attention import fused_attention
from hirest_tpu_torch.ops.quant import QuantDense
from hirest_tpu_torch.utils.device import resolve_device


def build_int8_vision_apply(params: Mapping,
                            cfg: EvaVisionConfig = EvaVisionConfig(), *,
                            quant_attention: bool = True,
                            dtype: torch.dtype = torch.bfloat16,
                            device=None):
    """params: a float EVA vision state dict (reference key names,
    `visual.`-prefixed or bare). Quantizes it on `device` and returns
    `apply(images [B, H, W, 3] NHWC) -> [B, embed_dim] f32`."""
    device = resolve_device(device)
    sd = eva_vision_state_dict(params)

    def f32(key):
        return torch.as_tensor(sd[key]).to(device=device, dtype=torch.float32)

    def dense(prefix, bias=True):
        return QuantDense(f32(f"{prefix}.weight"),
                          f32(f"{prefix}.bias") if bias else None, dtype)

    patch = QuantDense(patch_kernel(f32("patch_embed.proj.weight")).T,
                       f32("patch_embed.proj.bias"), dtype)
    head = dense("head")
    cls_token = f32("cls_token").to(dtype)
    pos = f32("pos_embed").to(dtype)
    norm = (f32("norm.weight"), f32("norm.bias"))

    blocks = []
    for i in range(cfg.layers):
        p = f"blocks.{i}"
        blk = {"norm1": (f32(f"{p}.norm1.weight"), f32(f"{p}.norm1.bias")),
               "norm2": (f32(f"{p}.norm2.weight"), f32(f"{p}.norm2.bias")),
               "q_bias": f32(f"{p}.attn.q_bias").to(dtype),
               "v_bias": f32(f"{p}.attn.v_bias").to(dtype),
               "fc1": dense(f"{p}.mlp.fc1"), "fc2": dense(f"{p}.mlp.fc2")}
        if quant_attention:
            blk["qkv"] = dense(f"{p}.attn.qkv", bias=False)
            blk["out"] = dense(f"{p}.attn.proj")
        else:
            qkv_w = f32(f"{p}.attn.qkv.weight").to(dtype)
            out_w = f32(f"{p}.attn.proj.weight").to(dtype)
            out_b = f32(f"{p}.attn.proj.bias").to(dtype)
            blk["qkv"] = lambda h, w=qkv_w: linear(h, w)
            blk["out"] = lambda a, w=out_w, b=out_b: linear(a, w, b)
        blocks.append(blk)

    heads, eps = cfg.num_heads, cfg.norm_eps
    scale = cfg.head_width ** -0.5
    p_sz = cfg.patch_size
    grid = cfg.image_size // p_sz

    @torch.inference_mode()
    def apply(images) -> torch.Tensor:
        x = torch.as_tensor(images).to(device=device, dtype=dtype)
        b = x.shape[0]
        x = x.reshape(b, grid, p_sz, grid, p_sz, 3).permute(0, 1, 3, 2, 4, 5)
        x = patch(x.reshape(b, grid * grid, p_sz * p_sz * 3))
        x = torch.cat([cls_token.expand(b, 1, cfg.width), x], 1) + pos
        for blk in blocks:
            h = _ln(x, *blk["norm1"], eps)
            q, k, v = blk["qkv"](h).chunk(3, -1)
            q, v = q + blk["q_bias"], v + blk["v_bias"]
            att = merge_heads(fused_attention(
                split_heads(q, heads), split_heads(k, heads),
                split_heads(v, heads), scale))
            x = x + blk["out"](att)
            h = _ln(x, *blk["norm2"], eps)
            x = x + blk["fc2"](gelu(blk["fc1"](h)))
        x = _ln(x, *norm, eps)
        return head(x[:, 0]).float()

    return apply
