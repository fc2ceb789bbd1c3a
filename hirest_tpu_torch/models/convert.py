"""Checkpoint loading and JAX-tree conversion for the EVA towers and the
joint model.

The port's modules use the reference's state-dict names, so a torch
checkpoint needs no renaming: `eva_vision_state_dict` and
`eva_text_state_dict` only strip the `visual.` or `text.` prefix, and
`load_moment_state_dict` applies only the reference's own key surgery
(`normalize_joint_keys`) and the position-table enlargement that the JAX
converters apply (hirest_tpu/models/convert.py:125-258).
`eva_vision_from_jax`, `eva_text_from_jax` and `moment_model_from_jax`
invert the JAX package's `convert_eva_vision`, `convert_eva_text` and
`convert_moment_model`, turning its flax parameter trees back into state
dicts: that is how weights are carried from one package to the other.
"""

from __future__ import annotations

import re
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


def _f32(v) -> torch.Tensor:
    return (v.float() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.asarray(v, dtype=np.float32)))


def _sub_state_dict(sd: Mapping, prefix: str) -> dict:
    """The keys of `sd` under `prefix`, without it, as f32 tensors."""
    return {k[len(prefix):]: _f32(v) for k, v in sd.items()
            if k.startswith(prefix)}


def _tower_state_dict(sd: Mapping, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in sd):
        return _sub_state_dict(sd, prefix)
    return _sub_state_dict(sd, "")


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


# ---------------------------------------------------------------------------
# The joint model (MomentModel) and its CLIP4Caption encoder and decoder
# ---------------------------------------------------------------------------


def normalize_joint_keys(sd: Mapping) -> dict:
    """The reference's checkpoint-loading key surgery (trainer_base.py:
    69-85,128-147): strip DDP's 'module.' and remap the legacy
    'vis_encoder.' to 'encoder.'."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^module\.", "", k)
        k = re.sub(r"^(model\.)?vis_encoder\.", r"\1encoder.", k)
        out[k] = v
    return out


def _enlarge_positions(sd: dict, rows: int) -> dict:
    """Copy the visual encoder's position table into `rows` rows, the tail
    zero: HiREST enlarges the pretrained 512-row table to 2048
    (modeling.py:110), as the JAX `convert_visual_encoder` does."""
    key = "embeddings.position_embeddings.weight"
    src = sd[key]
    pos = src.new_zeros(rows, src.shape[1])
    n = min(src.shape[0], rows)
    pos[:n] = src[:n]
    return {**sd, key: pos}


def load_moment_state_dict(model: nn.Module, sd: Mapping) -> nn.Module:
    """Load a trained reference-format joint checkpoint (`BEST.pth`, with
    or without DDP's `module.` and the legacy `vis_encoder.` names; the
    frozen `clip_model.*` keys, if any, are ignored) into a MomentModel."""
    sd = _sub_state_dict(normalize_joint_keys(sd), "")
    visual = _enlarge_positions(
        _sub_state_dict(sd, "clip4cap_model.visual."),
        model.config.visual.max_position_embeddings)
    sd.update({f"clip4cap_model.visual.{k}": v for k, v in visual.items()})
    return load_into(model, sd, "joint")


def init_from_clip4caption(model: nn.Module, clip4cap_sd: Mapping
                           ) -> nn.Module:
    """Overwrite a MomentModel's encoder and decoder with the pretrained
    CLIP4Caption weights (`clip4caption_vit-b-32_model.bin`: `visual.*`
    and `decoder.*`), the reference's from_pretrained initializer
    (modeling.py:102-110)."""
    visual = _enlarge_positions(_sub_state_dict(clip4cap_sd, "visual."),
                                model.config.visual.max_position_embeddings)
    load_into(model.encoder, visual, "clip4caption visual")
    load_into(model.decoder, _sub_state_dict(clip4cap_sd, "decoder."),
              "clip4caption decoder")
    return model


def _embed(prefix: str, tree) -> dict:
    return {f"{prefix}.weight": _t(tree["embedding"])}


def _bert_output(prefix: str, tree) -> dict:
    return {**_linear(f"{prefix}.dense", tree["dense"]),
            **_norm(f"{prefix}.LayerNorm", tree["LayerNorm"])}


def _bert_ffn(prefix: str, ffn) -> dict:
    return {**_linear(f"{prefix}.intermediate.dense", ffn["intermediate"]),
            **_linear(f"{prefix}.output.dense", ffn["output"]),
            **_norm(f"{prefix}.output.LayerNorm", ffn["LayerNorm"])}


def _qkv(prefix: str, tree) -> dict:
    return {k: v for name in ("query", "key", "value")
            for k, v in _linear(f"{prefix}.{name}", tree[name]).items()}


def _layers(p: Mapping) -> int:
    return sum(1 for k in p if k.startswith("layer_"))


def visual_encoder_from_jax(p: Mapping) -> dict:
    """JAX `VisualEncoder` parameters -> the port's VisualEncoder keys."""
    sd = {**_linear("embeddings.word_embeddings", p["word_embeddings"]),
          "embeddings.position_embeddings.weight":
              _t(p["position_embeddings"]),
          **_norm("embeddings.LayerNorm", p["emb_LayerNorm"])}
    for i in range(_layers(p)):
        blk, r = p[f"layer_{i}"], f"encoder.layer.{i}"
        sd.update(_qkv(f"{r}.attention.self", blk["attention"]))
        sd.update(_bert_output(f"{r}.attention.output",
                               blk["attention_output"]))
        sd.update(_bert_ffn(r, blk["ffn"]))
    return sd


def caption_decoder_from_jax(p: Mapping) -> dict:
    """JAX `CaptionDecoder` parameters -> the port's CaptionDecoder keys."""
    head = "classifier.cls.predictions"
    sd = {"embeddings.word_embeddings.weight": _t(p["word_embeddings"]),
          "embeddings.position_embeddings.weight":
              _t(p["position_embeddings"]),
          **_norm("embeddings.LayerNorm", p["emb_LayerNorm"]),
          **_linear(f"{head}.transform.dense", p["cls_transform"]),
          **_norm(f"{head}.transform.LayerNorm", p["cls_LayerNorm"]),
          f"{head}.bias": _t(p["cls_bias"])}
    for i in range(_layers(p)):
        blk, r = p[f"layer_{i}"], f"decoder.layer.{i}"
        for attn in ("slf", "enc"):
            sd.update(_qkv(f"{r}.{attn}_attn.att", blk[f"{attn}_attn"]))
            sd.update(_bert_output(f"{r}.{attn}_attn.output",
                                   blk[f"{attn}_output"]))
        sd.update(_bert_ffn(r, blk["ffn"]))
    return sd


def moment_model_from_jax(params: Mapping) -> dict:
    """JAX `MomentModel` parameters ({"params": {...}} or bare, numpy
    leaves) -> the port's (and the reference's) joint state dict: the
    inverse of `convert_moment_model`."""
    p = params["params"] if "params" in params else params
    sd = {**_linear("temporal_embed.0", p["temporal_fc1"]),
          **_linear("temporal_embed.2", p["temporal_fc2"]),
          **_embed("mask_embed", p["mask_embed"]),
          **_embed("boundary_embed", p["boundary_embed"]),
          **_linear("clip_g_map", p["clip_g_map"]),
          **_linear("clip_g_map_text", p["clip_g_map_text"]),
          **_norm("clip4cap_model.normalize_video.visual_norm2d",
                  p["normalize_video"]),
          **_linear("start_predictor.0", p["start_predictor"]),
          **_linear("end_predictor.0", p["end_predictor"]),
          **_linear("segment_predictor.0", p["segment_predictor"])}
    if "asr_norm" in p:
        sd.update(_norm("asr_enc_layer.0", p["asr_norm"]))
        sd.update(_linear("asr_enc_layer.1", p["asr_proj"]))
    for prefix, part in (("visual", visual_encoder_from_jax(p["encoder"])),
                         ("decoder", caption_decoder_from_jax(p["decoder"]))):
        sd.update({f"clip4cap_model.{prefix}.{k}": v
                   for k, v in part.items()})
    return sd
