"""Production forward of the EVA vision tower.

Counterpart of hirest_tpu/models/eva_scan.py. The JAX module stacks the
blocks under `lax.scan` to keep XLA's compile to one block; PyTorch runs
eagerly, so here the "scanned" forward is `EvaVisionTower` itself, staged
once on the device in the working dtype. The function names are kept so each
piece can be found beside its counterpart.

Only the flags that change numbers are carried over: `dtype`, `fast_gelu`,
`uint8_input` and `int8`. `int8=True` is the JAX package's production int8
configuration (int8 + fused_quant + attn_v3 + fused_mlp): `Int8Block` runs
ln_quant (K2), the int8 qkv and out products, the attention with its int8
epilogue (K3) and the fused int8 MLP (K4). The TPU layout flags (flat2d,
pad_tokens, xla_fences, attn_hg, attn_rows, attn_v2, remat) change no
numbers and have no counterpart: the trunk runs its 257 tokens unpadded.
"""

from __future__ import annotations

from typing import Callable, Mapping, Union

import numpy as np
import torch
from torch import nn

from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.models.convert import (eva_vision_state_dict,
                                             load_into, patch_conv,
                                             patch_kernel)
from hirest_tpu_torch.models.eva_clip import (CLIP_MEAN, CLIP_STD, Block,
                                              EvaVisionTower)
from hirest_tpu_torch.ops.attention import fused_attention_qkv3
from hirest_tpu_torch.ops.quant import (fused_mlp_int8, int8_mm, ln_quant,
                                        quantize_weight)
from hirest_tpu_torch.utils.device import resolve_device


def fold_uint8_frontend(patch_w: torch.Tensor, patch_b: torch.Tensor):
    """Fold CLIP pixel normalization ((x/255 - mean) / std, a per-channel
    affine) into the patch-embed projection, so the forward consumes raw
    uint8 frames: x_norm @ W + b == u8 @ (W * a[:, None]) + (bvec @ W + b)
    with a_c = 1/(255*std_c), bvec_c = -mean_c/std_c. Exact in f32.
    patch_w is the matmul kernel [p*p*3, width] (channel-minor rows)."""
    w = torch.as_tensor(patch_w, dtype=torch.float32)
    b = torch.as_tensor(patch_b, dtype=torch.float32)
    reps = w.shape[0] // 3
    a = torch.from_numpy(np.tile(1.0 / (255.0 * CLIP_STD), reps)).to(w.device)
    bvec = torch.from_numpy(np.tile(-CLIP_MEAN / CLIP_STD, reps)).to(w.device)
    return w * a[:, None], b + bvec @ w


class Int8Block(nn.Module):
    """The int8 block of the JAX production forward (eva_scan.block_flat
    with int8, fused_quant, attn_v3 and fused_mlp), made from a float
    `Block`.

    The four projections become per-output-channel int8 codes and f32
    scales, quantized from the block's float weights as they are (callers
    pass weights not yet cast to the working dtype). Every bias and norm
    parameter is rounded to `dtype` and kept as f32, which is what the JAX
    forward feeds its kernels. All of it lives in buffers, codes int8 and
    the rest f32; `forward` takes and returns x [B, S, C] in `dtype`."""

    def __init__(self, blk: Block, dtype: torch.dtype):
        super().__init__()
        attn, mlp = blk.attn, blk.mlp
        self.heads, self.scale = attn.heads, attn.scale
        self.eps = blk.norm1.eps

        def vec(t):
            return t.detach().to(dtype).float()

        bias3 = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias),
                           attn.v_bias])
        for name, t in (("norm1_w", blk.norm1.weight),
                        ("norm1_b", blk.norm1.bias), ("qkv_b", bias3),
                        ("out_b", attn.proj.bias),
                        ("norm2_w", blk.norm2.weight),
                        ("norm2_b", blk.norm2.bias),
                        ("fc1_b", mlp.fc1.bias), ("fc2_b", mlp.fc2.bias)):
            self.register_buffer(name, vec(t))
        for name, lin in (("qkv", attn.qkv), ("out", attn.proj),
                          ("fc1", mlp.fc1), ("fc2", mlp.fc2)):
            q, s = quantize_weight(lin.weight.detach())
            self.register_buffer(f"{name}_wq", q)
            self.register_buffer(f"{name}_ws", s)

    def forward(self, x: torch.Tensor, fast_gelu: bool) -> torch.Tensor:
        b, s, c = x.shape
        x = x.reshape(b * s, c)
        h_q, h_s = ln_quant(x, self.norm1_w, self.norm1_b, self.eps)
        qkv = int8_mm(h_q, h_s, self.qkv_wq, self.qkv_ws, self.qkv_b, x.dtype)
        a_q, a_s = fused_attention_qkv3(qkv.view(b, s, -1), self.scale,
                                        self.heads, quant_out=True)
        x = x + int8_mm(a_q.view(b * s, -1), a_s.view(b * s, 1), self.out_wq,
                        self.out_ws, self.out_b, x.dtype)
        h_q, h_s = ln_quant(x, self.norm2_w, self.norm2_b, self.eps)
        x = fused_mlp_int8(h_q, h_s, self.fc1_wq, self.fc1_ws, self.fc1_b,
                           self.fc2_wq, self.fc2_ws, self.fc2_b, x,
                           act="gelu_poly" if fast_gelu else "gelu")
        return x.view(b, s, c)


def build_scanned_vision_apply(params: Union[Mapping, nn.Module],
                               cfg: EvaVisionConfig = EvaVisionConfig(), *,
                               dtype: torch.dtype = torch.bfloat16,
                               fast_gelu: bool = True,
                               uint8_input: bool = False, int8: bool = False,
                               device=None) -> Callable:
    """Stage the tower on `device` once and return
    `apply(images [B, H, W, 3] NHWC) -> [B, embed_dim] f32`.

    params: an EVA vision state dict (reference names, `visual.`-prefixed
    or bare; tensors or numpy arrays) or an `EvaVisionTower`; it is not
    modified. With heads padded to 128 (models/eva_pad.py, `cfg` from
    pad_vision_head_params) the heads come from `cfg.num_heads` and the
    attention runs at head width 128. Every parameter is cast to `dtype` except the final
    LayerNorm's, which stays f32 as in the JAX forward.
    uint8_input: apply() takes raw uint8 0..255 frames; pixel normalization
    is folded into the patch embed (fold_uint8_frontend).
    int8: every block is an `Int8Block`, its codes quantized on `device`
    from the float weights before anything is cast to `dtype`."""
    device = resolve_device(device)
    sd = dict(params.state_dict() if isinstance(params, nn.Module)
              else eva_vision_state_dict(params))
    if uint8_input:
        w, b = fold_uint8_frontend(
            patch_kernel(sd["patch_embed.proj.weight"].float().cpu()),
            sd["patch_embed.proj.bias"].float().cpu())
        sd["patch_embed.proj.weight"] = patch_conv(w)
        sd["patch_embed.proj.bias"] = b
    with torch.device("meta"):
        tower = EvaVisionTower(cfg, fast_gelu=fast_gelu)
    load_into(tower, sd, "EVA vision")
    if int8:
        blocks = nn.ModuleList(Int8Block(blk.to(device), dtype)
                               for blk in tower.blocks)
        tower.blocks = nn.ModuleList()  # .to(dtype) must not cast the scales
    tower = tower.to(device=device, dtype=dtype).eval()
    tower.norm.float()
    if int8:
        tower.blocks = blocks.eval()

    @torch.inference_mode()
    def apply(images) -> torch.Tensor:
        return tower(torch.as_tensor(images).to(device))

    return apply
