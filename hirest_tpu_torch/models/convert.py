"""Checkpoint loading and JAX-tree conversion for the EVA vision tower.

The port's modules use the EVA reference's state-dict names, so a torch
checkpoint needs no renaming: `eva_vision_state_dict` only strips the
`visual.` prefix. `eva_vision_from_jax` inverts the JAX package's
`convert_eva_vision` (hirest_tpu/models/convert.py:89-117), turning its
`EvaVisionTower` parameter tree back into a state dict.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def load_torch_ckpt(path: str) -> dict:
    """Load a torch checkpoint (.pt/.bin, optionally wrapped in
    `state_dict`) into a flat {key: float32 tensor} dict on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v).detach().float() for k, v in sd.items()}


def eva_vision_state_dict(sd: Mapping) -> dict:
    """A state dict with `visual.*` keys (the whole CLIP checkpoint) or bare
    vision keys -> the vision tower's keys, as float32 tensors."""
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}
    return {k: v.float() if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.asarray(v, dtype=np.float32))
            for k, v in sd.items()}


def patch_kernel(conv_w: torch.Tensor) -> torch.Tensor:
    """Patch-embed conv weight [width, 3, p, p] -> matmul kernel
    [p*p*3, width] in the patchify's (row, col, channel) order
    (hirest_tpu/models/convert.py:93-95)."""
    return conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0])


def patch_conv(kernel: torch.Tensor) -> torch.Tensor:
    """Inverse of patch_kernel."""
    patch = int(round((kernel.shape[0] // 3) ** 0.5))
    return kernel.reshape(patch, patch, 3, -1).permute(3, 2, 0, 1).contiguous()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def eva_vision_from_jax(params: Mapping) -> dict:
    """JAX `EvaVisionTower` parameters ({"params": {...}} or bare, numpy
    leaves) -> the port's state dict: kernels [in, out] -> weights
    [out, in], LayerNorm scale -> weight, patch kernel [p*p*3, width] in
    (row, col, channel) order -> conv weight [width, 3, p, p]."""
    p = params["params"] if "params" in params else params

    def linear(prefix, tree):
        return {f"{prefix}.weight": _t(tree["kernel"]).T.contiguous(),
                f"{prefix}.bias": _t(tree["bias"])}

    def norm(prefix, tree):
        return {f"{prefix}.weight": _t(tree["scale"]),
                f"{prefix}.bias": _t(tree["bias"])}

    sd = {
        "patch_embed.proj.weight": patch_conv(_t(p["patch_embed"]["kernel"])),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
        "cls_token": _t(p["cls_token"]),
        "pos_embed": _t(p["pos_embed"]),
        **norm("norm", p["norm"]),
        **linear("head", p["head"]),
    }
    n_blocks = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_blocks):
        blk, r = p[f"block_{i}"], f"blocks.{i}"
        sd.update(norm(f"{r}.norm1", blk["norm1"]))
        sd.update(norm(f"{r}.norm2", blk["norm2"]))
        sd[f"{r}.attn.qkv.weight"] = _t(
            blk["attn"]["qkv"]["kernel"]).T.contiguous()
        sd[f"{r}.attn.q_bias"] = _t(blk["attn"]["q_bias"])
        sd[f"{r}.attn.v_bias"] = _t(blk["attn"]["v_bias"])
        sd.update(linear(f"{r}.attn.proj", blk["attn"]["out"]))
        sd.update(linear(f"{r}.mlp.fc1", blk["mlp_fc1"]))
        sd.update(linear(f"{r}.mlp.fc2", blk["mlp_fc2"]))
    return sd
