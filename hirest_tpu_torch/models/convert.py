"""Checkpoint loading and JAX-tree conversion for the EVA towers, the
joint model, Whisper, MiniLM, the OpenAI CLIP towers and the NLI
cross-encoder.

The port's modules use the reference's state-dict names, so a torch
checkpoint needs no renaming: `eva_vision_state_dict` and
`eva_text_state_dict` only strip the `visual.` or `text.` prefix, and
`load_moment_state_dict` applies only the reference's own key surgery
(`normalize_joint_keys`) and the position-table enlargement that the JAX
converters apply (hirest_tpu/models/convert.py:125-258).
`eva_vision_from_jax`, `eva_text_from_jax`, `moment_model_from_jax`,
`whisper_from_jax`, `minilm_from_jax`, `clip_from_jax`,
`clip_resnet_from_jax` and `nli_from_jax` invert the JAX package's
`convert_eva_vision`, `convert_eva_text`, `convert_moment_model`,
`convert_whisper_encoder`/`_decoder`, `convert_minilm`,
`convert_clip_text`/`convert_clip_vision`, `convert_clip_resnet` and
`convert_nli`, turning its flax parameter trees back into state dicts:
that is how weights are carried from one package to the other.

`load_safetensors` reads the `.safetensors` format itself (the
`safetensors` package is not needed) and `save_safetensors` writes it: an
8-byte little-endian header length, a JSON header of dtype, shape and byte
offsets per tensor, then the raw little-endian buffers.
"""

from __future__ import annotations

import json
import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

# safetensors dtype -> the numpy dtype of its buffer (BF16 is read as its
# 16 bits and widened to f32 by a shift)
_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2",
                       "BF16": "<u2", "I64": "<i8", "I32": "<i4",
                       "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def load_safetensors(path: str) -> dict:
    """A `.safetensors` file -> {key: CPU tensor in the file's dtype}
    (F64, F32, F16, BF16, I64, I32, I16, I8, U8, BOOL)."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        kind = info["dtype"]
        if kind not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {key} has unsupported dtype {kind}")
        lo, hi = info["data_offsets"]
        a = np.frombuffer(data, dtype=_SAFETENSORS_DTYPES[kind],
                          count=(hi - lo) // np.dtype(
                              _SAFETENSORS_DTYPES[kind]).itemsize,
                          offset=base + lo).reshape(info["shape"])
        if kind == "BF16":
            t = torch.from_numpy((a.astype(np.uint32) << 16).view(np.float32)
                                 ).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a.astype(a.dtype.newbyteorder("="),
                                          copy=True))
        out[key] = t
    return out


def save_safetensors(path, arrays: Mapping) -> None:
    """Write {key: numpy array or CPU tensor} (F32, F16, I64, ...; no BF16)
    as a `.safetensors` file, the keys sorted as the format's writers sort
    them, each buffer 8-byte aligned."""
    names = {np.dtype(v).str.lstrip("<|="): k
             for k, v in _SAFETENSORS_DTYPES.items() if k != "BF16"}
    header, blobs, offset = {}, [], 0
    for key in sorted(arrays):
        v = arrays[key]
        a = np.ascontiguousarray(v.numpy() if isinstance(v, torch.Tensor)
                                 else v)
        kind = names.get(a.dtype.newbyteorder("<").str.lstrip("<|="))
        if kind is None:
            raise ValueError(f"{key}: no safetensors dtype for {a.dtype}")
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[key] = {"dtype": kind, "shape": list(a.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_torch_ckpt(path: str) -> dict:
    """Load a torch checkpoint (.pt/.bin, optionally wrapped in
    `state_dict`) or a `.safetensors` file into a flat {key: float32
    tensor} dict on the CPU."""
    if str(path).endswith(".safetensors"):
        return {k: v.float() for k, v in load_safetensors(path).items()}
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


def _resblocks(p: Mapping) -> dict:
    """The flax TextBlocks `block_i` of a text or CLIP tower -> torch
    `transformer.resblocks.i.*` keys (nn.MultiheadAttention's packing)."""
    sd = {}
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


def eva_text_from_jax(params: Mapping) -> dict:
    """JAX `EvaTextTower` parameters ({"params": {...}} or bare, numpy
    leaves) -> the port's state dict (the reference's `text.*` names
    without the prefix): the inverse of `convert_eva_text`."""
    p = params["params"] if "params" in params else params
    return {
        "token_embedding.weight": _t(p["token_embedding"]["embedding"]),
        "positional_embedding": _t(p["positional_embedding"]),
        **_norm("ln_final", p["ln_final"]),
        "text_projection": _t(p["text_projection"]),
        **_resblocks(p),
    }


def clip_from_jax(text_params: Mapping, vision_params: Mapping = None,
                  logit_scale: float = None) -> dict:
    """JAX `ClipTextTower` (and `ClipVisionTower`) parameters ({"params":
    {...}} or bare, numpy leaves) -> an OpenAI CLIP state dict: the text
    keys at the top level, the vision keys under `visual.`, and
    `logit_scale` (its log) when given: the inverse of `convert_clip_text`
    and `convert_clip_vision`. The patch kernel [p*p*3, width] in (row,
    col, channel) order goes back to conv1's [width, 3, p, p]."""
    sd = eva_text_from_jax(text_params)
    if vision_params is not None:
        p = vision_params["params"] if "params" in vision_params \
            else vision_params
        visual = {
            "conv1.weight": patch_conv(_t(p["patch_embed"]["kernel"])),
            "class_embedding": _t(p["class_embedding"]),
            "positional_embedding": _t(p["positional_embedding"]),
            **_norm("ln_pre", p["ln_pre"]),
            **_norm("ln_post", p["ln_post"]),
            "proj": _t(p["proj"]),
            **_resblocks(p),
        }
        sd.update({f"visual.{k}": v for k, v in visual.items()})
    if logit_scale is not None:
        sd["logit_scale"] = torch.tensor(np.log(logit_scale),
                                         dtype=torch.float32)
    return sd


def clip_resnet_from_jax(params: Mapping, eps: float = 1e-5) -> dict:
    """JAX `ClipResNetTower` parameters ({"params": {...}} or bare, numpy
    leaves) -> the port's ClipResNetTower state dict (the reference's
    names without `visual.`): flax conv kernels [kh, kw, in, out] -> torch
    [out, in, kh, kw]; each folded affine (scale, bias) -> a BatchNorm with
    weight = scale, bias = bias, running mean 0 and running variance
    1 - eps, which gives x * scale + bias again."""
    p = params["params"] if "params" in params else params

    def conv(tree):
        return _t(tree["kernel"]).permute(3, 2, 0, 1).contiguous()

    def bn(prefix, tree):
        n = np.asarray(tree["scale"]).shape[0]
        return {f"{prefix}.weight": _t(tree["scale"]),
                f"{prefix}.bias": _t(tree["bias"]),
                f"{prefix}.running_mean": torch.zeros(n),
                f"{prefix}.running_var": torch.full((n,), 1.0 - eps)}

    sd = {}
    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = conv(p[f"conv{i}"])
        sd.update(bn(f"bn{i}", p[f"bn{i}"]))
    for name, blk in p.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m is None:
            continue
        r = f"layer{m[1]}.{m[2]}"
        for i in (1, 2, 3):
            sd[f"{r}.conv{i}.weight"] = conv(blk[f"conv{i}"])
            sd.update(bn(f"{r}.bn{i}", blk[f"bn{i}"]))
        if "down_conv" in blk:
            sd[f"{r}.downsample.0.weight"] = conv(blk["down_conv"])
            sd.update(bn(f"{r}.downsample.1", blk["down_bn"]))
    pool = p["attnpool"]
    sd["attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd.update(_linear(f"attnpool.{name}", pool[name]))
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


# ---------------------------------------------------------------------------
# Whisper and MiniLM
# ---------------------------------------------------------------------------


def _whisper_attn(prefix: str, tree) -> dict:
    return {**_linear(f"{prefix}.q_proj", tree["q_proj"]),
            f"{prefix}.k_proj.weight": _t(
                tree["k_proj"]["kernel"]).T.contiguous(),
            **_linear(f"{prefix}.v_proj", tree["v_proj"]),
            **_linear(f"{prefix}.out_proj", tree["out_proj"])}


def _whisper_layers(prefix: str, p: Mapping, cross: bool) -> dict:
    sd = {}
    n = sum(1 for k in p if k.startswith("layers_"))
    for i in range(n):
        blk, r = p[f"layers_{i}"], f"{prefix}.layers.{i}"
        names = ("self_attn", "encoder_attn") if cross else ("self_attn",)
        for attn in names:
            sd.update(_whisper_attn(f"{r}.{attn}", blk[attn]))
            sd.update(_norm(f"{r}.{attn}_layer_norm",
                            blk[f"{attn}_layer_norm"]))
        sd.update(_linear(f"{r}.fc1", blk["fc1"]))
        sd.update(_linear(f"{r}.fc2", blk["fc2"]))
        sd.update(_norm(f"{r}.final_layer_norm", blk["final_layer_norm"]))
    return sd


def whisper_from_jax(enc_params: Mapping, dec_params: Mapping) -> dict:
    """JAX `WhisperEncoder` and `WhisperDecoder` parameters ({"params":
    {...}} or bare, numpy leaves) -> one HF `WhisperModel` state dict
    (`encoder.*`, `decoder.*`), the port's names: the inverse of
    `convert_whisper_encoder` / `convert_whisper_decoder`. flax conv
    kernels [k, in, out] -> torch Conv1d weights [out, in, k]."""
    e = enc_params["params"] if "params" in enc_params else enc_params
    d = dec_params["params"] if "params" in dec_params else dec_params
    sd = {}
    for conv in ("conv1", "conv2"):
        sd[f"encoder.{conv}.weight"] = _t(
            e[conv]["kernel"]).permute(2, 1, 0).contiguous()
        sd[f"encoder.{conv}.bias"] = _t(e[conv]["bias"])
    sd.update(_norm("encoder.layer_norm", e["layer_norm"]))
    sd.update(_whisper_layers("encoder", e, cross=False))
    sd["decoder.embed_tokens.weight"] = _t(d["embed_tokens"])
    sd["decoder.embed_positions.weight"] = _t(d["embed_positions"])
    sd.update(_norm("decoder.layer_norm", d["layer_norm"]))
    sd.update(_whisper_layers("decoder", d, cross=True))
    return sd


def nli_from_jax(params: Mapping) -> dict:
    """JAX `NliCrossEncoder` parameters ({"params": {...}} or bare, numpy
    leaves) -> an HF `BertForSequenceClassification` state dict (`bert.*`,
    `bert.pooler.dense`, `classifier`): the inverse of `convert_nli`."""
    p = params["params"] if "params" in params else params
    return {**{f"bert.{k}": v
               for k, v in minilm_from_jax(p["encoder"]).items()},
            **_linear("bert.pooler.dense", p["pooler"]),
            **_linear("classifier", p["classifier"])}


def minilm_from_jax(params: Mapping) -> dict:
    """JAX `MiniLmEncoder` parameters ({"params": {...}} or bare, numpy
    leaves) -> the port's (HF `BertModel`'s) state dict: the inverse of
    `convert_minilm`."""
    p = params["params"] if "params" in params else params
    sd = {"embeddings.word_embeddings.weight":
              _t(p["word_embeddings"]["embedding"]),
          "embeddings.position_embeddings.weight":
              _t(p["position_embeddings"]),
          "embeddings.token_type_embeddings.weight":
              _t(p["token_type_embeddings"]),
          **_norm("embeddings.LayerNorm", p["emb_LayerNorm"])}
    n = sum(1 for k in p if re.fullmatch(r"layer_\d+_ffn", k))
    for i in range(n):
        r = f"encoder.layer.{i}"
        sd.update(_qkv(f"{r}.attention.self", p[f"layer_{i}_attention"]))
        sd.update(_bert_output(f"{r}.attention.output",
                               p[f"layer_{i}_attention_output"]))
        sd.update(_bert_ffn(r, p[f"layer_{i}_ffn"]))
    return sd
