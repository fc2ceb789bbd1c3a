"""Checkpoint loading and JAX-tree conversion for the EVA towers.

The port's modules use the EVA reference's state-dict names, so a torch
checkpoint needs no renaming: `eva_vision_state_dict` and
`eva_text_state_dict` only strip the `visual.` or `text.` prefix.
`eva_vision_from_jax` and `eva_text_from_jax` invert the JAX package's
`convert_eva_vision` and `convert_eva_text`
(hirest_tpu/models/convert.py:63-117), turning its `EvaVisionTower` and
`EvaTextTower` parameter trees back into state dicts.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def load_torch_ckpt(path: str) -> dict:
    """Load a torch checkpoint (.pt/.bin, optionally wrapped in
    `state_dict`) into a flat {key: float32 tensor} dict on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v).detach().float() for k, v in sd.items()}


def _tower_state_dict(sd: Mapping, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return {k: v.float() if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.asarray(v, dtype=np.float32))
            for k, v in sd.items()}


def eva_vision_state_dict(sd: Mapping) -> dict:
    """A state dict with `visual.*` keys (the whole CLIP checkpoint) or bare
    vision keys -> the vision tower's keys, as float32 tensors."""
    return _tower_state_dict(sd, "visual.")


def eva_text_state_dict(sd: Mapping) -> dict:
    """A state dict with `text.*` keys (the whole CLIP checkpoint) or bare
    text keys -> the text tower's keys, as float32 tensors."""
    return _tower_state_dict(sd, "text.")


def load_into(module: nn.Module, sd: Mapping, what: str) -> nn.Module:
    """Load `sd` into `module` by assignment, ignoring keys it does not
    have; raise KeyError when it lacks one the module needs."""
    missing, _ = module.load_state_dict(sd, strict=False, assign=True)
    if missing:
        raise KeyError(f"{what} state dict lacks {len(missing)} keys, "
                       f"e.g. {missing[:3]}")
    return module


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


def _linear(prefix: str, tree) -> dict:
    """flax Dense kernel [in, out] -> torch Linear weight [out, in]."""
    return {f"{prefix}.weight": _t(tree["kernel"]).T.contiguous(),
            f"{prefix}.bias": _t(tree["bias"])}


def _norm(prefix: str, tree) -> dict:
    return {f"{prefix}.weight": _t(tree["scale"]),
            f"{prefix}.bias": _t(tree["bias"])}


def _blocks(p: Mapping) -> int:
    return sum(1 for k in p if k.startswith("block_"))


def eva_vision_from_jax(params: Mapping) -> dict:
    """JAX `EvaVisionTower` parameters ({"params": {...}} or bare, numpy
    leaves) -> the port's state dict: kernels [in, out] -> weights
    [out, in], LayerNorm scale -> weight, patch kernel [p*p*3, width] in
    (row, col, channel) order -> conv weight [width, 3, p, p]."""
    p = params["params"] if "params" in params else params
    sd = {
        "patch_embed.proj.weight": patch_conv(_t(p["patch_embed"]["kernel"])),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
        "cls_token": _t(p["cls_token"]),
        "pos_embed": _t(p["pos_embed"]),
        **_norm("norm", p["norm"]),
        **_linear("head", p["head"]),
    }
    for i in range(_blocks(p)):
        blk, r = p[f"block_{i}"], f"blocks.{i}"
        sd.update(_norm(f"{r}.norm1", blk["norm1"]))
        sd.update(_norm(f"{r}.norm2", blk["norm2"]))
        sd[f"{r}.attn.qkv.weight"] = _t(
            blk["attn"]["qkv"]["kernel"]).T.contiguous()
        sd[f"{r}.attn.q_bias"] = _t(blk["attn"]["q_bias"])
        sd[f"{r}.attn.v_bias"] = _t(blk["attn"]["v_bias"])
        sd.update(_linear(f"{r}.attn.proj", blk["attn"]["out"]))
        sd.update(_linear(f"{r}.mlp.fc1", blk["mlp_fc1"]))
        sd.update(_linear(f"{r}.mlp.fc2", blk["mlp_fc2"]))
    return sd


def eva_text_from_jax(params: Mapping) -> dict:
    """JAX `EvaTextTower` parameters ({"params": {...}} or bare, numpy
    leaves) -> the port's state dict (the reference's `text.*` names
    without the prefix): the inverse of `convert_eva_text`."""
    p = params["params"] if "params" in params else params
    sd = {
        "token_embedding.weight": _t(p["token_embedding"]["embedding"]),
        "positional_embedding": _t(p["positional_embedding"]),
        **_norm("ln_final", p["ln_final"]),
        "text_projection": _t(p["text_projection"]),
    }
    for i in range(_blocks(p)):
        blk, r = p[f"block_{i}"], f"transformer.resblocks.{i}"
        sd.update(_norm(f"{r}.ln_1", blk["ln_1"]))
        sd.update(_norm(f"{r}.ln_2", blk["ln_2"]))
        sd[f"{r}.attn.in_proj_weight"] = _t(
            blk["attn"]["qkv"]["kernel"]).T.contiguous()
        sd[f"{r}.attn.in_proj_bias"] = _t(blk["attn"]["qkv_bias"])
        sd.update(_linear(f"{r}.attn.out_proj", blk["attn"]["out"]))
        sd.update(_linear(f"{r}.mlp.c_fc", blk["mlp_c_fc"]))
        sd.update(_linear(f"{r}.mlp.c_proj", blk["mlp_c_proj"]))
    return sd
