"""Production forward of the EVA vision tower.

Counterpart of hirest_tpu/models/eva_scan.py. The JAX module stacks the
blocks under `lax.scan` to keep XLA's compile to one block; PyTorch runs
eagerly, so here the "scanned" forward is `EvaVisionTower` itself, staged
once on the device in the working dtype. The function names are kept so each
piece can be found beside its counterpart.

Only the flags that change numbers are carried over: `dtype`, `fast_gelu`
and `uint8_input` (and `int8`, which is the next slice). The TPU layout flags
(flat2d, pad_tokens, xla_fences, attn_hg, attn_rows, attn_v2, remat) change
no numbers and have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Mapping, Union

import numpy as np
import torch
from torch import nn

from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.models.convert import (eva_vision_state_dict,
                                             patch_conv, patch_kernel)
from hirest_tpu_torch.models.eva_clip import (CLIP_MEAN, CLIP_STD,
                                              EvaVisionTower)
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
    modified. Every parameter is cast to `dtype` except the final
    LayerNorm's, which stays f32 as in the JAX forward.
    uint8_input: apply() takes raw uint8 0..255 frames; pixel normalization
    is folded into the patch embed (fold_uint8_frontend)."""
    if int8:
        raise NotImplementedError(
            "the int8 forward (ln_quant, the int8 attention epilogue, "
            "fused_mlp_int8 and the int8 GEMMs) is the port's next slice")
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
    missing, _ = tower.load_state_dict(sd, strict=False, assign=True)
    if missing:
        raise KeyError(f"EVA vision state dict lacks {len(missing)} keys, "
                       f"e.g. {missing[:3]}")
    tower = tower.to(device=device, dtype=dtype).eval()
    tower.norm.float()

    @torch.inference_mode()
    def apply(images) -> torch.Tensor:
        return tower(torch.as_tensor(images).to(device))

    return apply
