"""Whisper ASR in PyTorch.

Counterpart of hirest_tpu/models/whisper.py (flax), with the same arithmetic
in f32 and the parameter names of HuggingFace `WhisperModel` (openai/whisper-*
hub checkpoints), so that an HF state dict, bare or under `model.`, loads
with `load_state_dict` (`load_whisper`):

- `WhisperEncoder`: log-mel [B, T, 80] (time-major, as the JAX module takes
  it) -> two 1-D convs (k=3; stride 1 then 2) + GELU, the fixed sinusoidal
  positions `sinusoids(1500, d)[:T]`, pre-LN transformer layers (k_proj has
  no bias), final LayerNorm -> [B, T/2, d].
- `WhisperDecoder`: token + learned position embeddings, pre-LN layers with
  causal self-attention and cross-attention, final LayerNorm, the head tied
  to `embed_tokens` with f32 logits. `decode_step` is the KV-cached
  one-token path: the cross-attention K/V are projected once (`cross_kv`),
  the self-attention K/V accumulate in fixed [N, L, d] caches
  (`init_cache`) that a step writes in place at its position.

The GELU is exact erf (the port's `layers.gelu`). The LayerNorms are
torch's: in f32 its two-pass variance and flax's E[x^2] - E[x]^2 differ by
rounding only, and one fused kernel a norm keeps the host-driven decode
step's launch count down. Token and position gathers clamp out-of-range
indices to the last row, as JAX's gathers do. Attention is the plain
`dot_product_attention`: the JAX Whisper reaches no Pallas kernel, and
neither does this one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from hirest_tpu_torch.models.layers import (dot_product_attention, gelu,
                                            merge_heads, split_heads)


@dataclass(frozen=True)
class WhisperConfig:
    """Defaults = whisper small.en."""

    num_mel_bins: int = 80
    d_model: int = 768
    encoder_layers: int = 12
    decoder_layers: int = 12
    heads: int = 12
    ffn_dim: int = 3072
    max_source_positions: int = 1500   # 30 s of audio after the stride-2 conv
    max_target_positions: int = 448
    vocab_size: int = 51864            # the .en vocabulary
    norm_eps: float = 1e-5


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal table (also stored in HF checkpoints)."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


class _Attn(nn.Module):
    """q/k/v/out projections with Whisper's no-bias k_proj quirk."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def _attend(self, q, k, v, bias):
        h = self.heads
        out = dot_product_attention(split_heads(q, h), split_heads(k, h),
                                    split_heads(v, h), bias,
                                    (q.shape[-1] // h) ** -0.5)
        return merge_heads(out)

    def forward(self, x, kv=None, bias=None):
        kv = x if kv is None else kv
        out = self._attend(self.q_proj(x), self.k_proj(kv), self.v_proj(kv),
                           bias)
        return self.out_proj(out)

    def step(self, x, pos: int, cache_k, cache_v):
        """Cached causal self-attention for one token: x [N, 1, D]; writes
        the caches' slot `pos` in place and attends over slots <= pos."""
        cache_k[:, pos] = self.k_proj(x)[:, 0]
        cache_v[:, pos] = self.v_proj(x)[:, 0]
        ids = torch.arange(cache_k.shape[1], device=x.device)
        bias = torch.zeros(ids.shape, device=x.device).masked_fill(
            ids > pos, float("-inf"))
        out = self._attend(self.q_proj(x), cache_k, cache_v, bias)
        return self.out_proj(out), cache_k, cache_v

    def cross_step(self, x, enc_k, enc_v):
        return self.out_proj(self._attend(self.q_proj(x), enc_k, enc_v, None))

    def cross_kv(self, enc):
        return self.k_proj(enc), self.v_proj(enc)


class _Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 behind its pre-LN, as a layer's base so the
    parameters carry HF's layer-level names."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.norm_eps)

    def mlp(self, x):
        return x + self.fc2(gelu(self.fc1(self.final_layer_norm(x))))


class EncoderLayer(_Mlp):
    def __init__(self, cfg: WhisperConfig):
        super().__init__(cfg)
        self.self_attn = _Attn(cfg.d_model, cfg.heads)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.norm_eps)

    def forward(self, x):
        return self.mlp(x + self.self_attn(self.self_attn_layer_norm(x)))


class DecoderLayer(_Mlp):
    def __init__(self, cfg: WhisperConfig):
        super().__init__(cfg)
        self.self_attn = _Attn(cfg.d_model, cfg.heads)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.norm_eps)
        self.encoder_attn = _Attn(cfg.d_model, cfg.heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(cfg.d_model,
                                                    eps=cfg.norm_eps)

    def forward(self, x, enc, self_bias):
        x = x + self.self_attn(self.self_attn_layer_norm(x), bias=self_bias)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), kv=enc)
        return self.mlp(x)

    def step(self, x, pos: int, enc_k, enc_v, cache_k, cache_v):
        h, cache_k, cache_v = self.self_attn.step(
            self.self_attn_layer_norm(x), pos, cache_k, cache_v)
        x = x + h
        x = x + self.encoder_attn.cross_step(self.encoder_attn_layer_norm(x),
                                             enc_k, enc_v)
        return self.mlp(x), cache_k, cache_v


class WhisperEncoder(nn.Module):
    """log-mel features [B, T_mel, 80] (time-major) -> [B, T_mel/2, D]."""

    def __init__(self, cfg: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2,
                               padding=1)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.norm_eps)
        self.register_buffer("positions", torch.from_numpy(sinusoids(
            cfg.max_source_positions, cfg.d_model)), persistent=False)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = gelu(self.conv1(mel.float().transpose(1, 2)))
        x = gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positions[: x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class WhisperDecoder(nn.Module):
    """token ids [B, L] + encoder states [B, T, D] -> logits [B, L, V] f32."""

    def __init__(self, cfg: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Embedding(cfg.max_target_positions,
                                            cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.norm_eps)

    def _tokens(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.embed_tokens.weight
        return table[ids.long().clamp(0, table.shape[0] - 1)]

    def _head(self, x):
        return (self.layer_norm(x) @ self.embed_tokens.weight.T).float()

    def forward(self, ids: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        length = ids.shape[1]
        x = self._tokens(ids) + self.embed_positions.weight[:length]
        bias = torch.full((length, length), float("-inf"),
                          device=x.device).triu(1)
        for layer in self.layers:
            x = layer(x, enc, bias)
        return self._head(x)

    # -- cached decoding -----------------------------------------------

    def init_cache(self, batch: int, max_len: int):
        shape = (batch, max_len, self.cfg.d_model)
        device = self.embed_tokens.weight.device
        return tuple((torch.zeros(shape, device=device),
                      torch.zeros(shape, device=device))
                     for _ in self.layers)

    def cross_kv(self, enc):
        return tuple(layer.encoder_attn.cross_kv(enc) for layer in self.layers)

    def decode_step(self, tok_ids: torch.Tensor, pos: int, cross_kv, cache):
        """tok_ids [N] at position `pos` -> (logits [N, V] f32, cache); the
        caches' slot `pos` is written in place."""
        row = min(pos, self.cfg.max_target_positions - 1)
        x = (self._tokens(tok_ids)[:, None]
             + self.embed_positions.weight[row: row + 1])
        new_cache = []
        for layer, (ek, ev), (ck, cv) in zip(self.layers, cross_kv, cache):
            x, ck, cv = layer.step(x, pos, ek, ev, ck, cv)
            new_cache.append((ck, cv))
        return self._head(x)[:, 0], tuple(new_cache)


@torch.inference_mode()
def greedy_decode(decoder: WhisperDecoder, enc: torch.Tensor,
                  prompt_ids: np.ndarray, max_new_tokens: int,
                  eot_id: int) -> np.ndarray:
    """Greedy generation with the KV cache. prompt_ids [B, P] seeds the
    decode (Whisper's <sot> [task tokens] prefix); returns [B, P+N].

    The steps of the JAX function's scan, as a plain loop on the device:
    inside the prompt the given tokens are fed; after it the argmax is
    written, EOT held once a row is done; `done` is set only outside the
    prompt. The ids come back to the host once, at the end."""
    b, p = prompt_ids.shape
    total = p + max_new_tokens
    device = enc.device
    ids = torch.zeros((b, total), dtype=torch.int32, device=device)
    ids[:, :p] = torch.as_tensor(prompt_ids, dtype=torch.int32, device=device)
    cross = decoder.cross_kv(enc)
    cache = decoder.init_cache(b, total)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    for t in range(total - 1):
        logits, cache = decoder.decode_step(ids[:, t], t, cross, cache)
        nxt = logits.argmax(-1).to(torch.int32)
        if t + 1 < p:
            continue  # within the prompt: the given token stays
        ids[:, t + 1] = torch.where(done, eot_id, nxt)
        done |= nxt == eot_id
    return ids.cpu().numpy()


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------


def infer_whisper_config(sd) -> WhisperConfig:
    """Derive the architecture from state-dict shapes (HF `WhisperModel`
    names, bare) so any whisper size (tiny/base/small/medium, .en or
    multilingual) loads without a config flag. Head count follows the
    universal whisper head width of 64."""
    get = lambda k: sd[k].shape  # noqa: E731
    vocab, d_model = get("decoder.embed_tokens.weight")
    max_tgt = get("decoder.embed_positions.weight")[0]
    num_mel = get("encoder.conv1.weight")[1]
    ffn = get("encoder.layers.0.fc1.weight")[0]

    def n_layers(prefix):
        ns = {int(k.split(".")[2]) for k in sd
              if k.startswith(prefix) and k.split(".")[2].isdigit()}
        return max(ns) + 1

    if "encoder.embed_positions.weight" in sd:
        max_src = get("encoder.embed_positions.weight")[0]
    else:
        max_src = 1500
    return WhisperConfig(
        num_mel_bins=int(num_mel), d_model=int(d_model),
        encoder_layers=n_layers("encoder.layers."),
        decoder_layers=n_layers("decoder.layers."),
        heads=int(d_model) // 64, ffn_dim=int(ffn),
        max_source_positions=int(max_src),
        max_target_positions=int(max_tgt), vocab_size=int(vocab))


def load_whisper(sd: Mapping, cfg: Optional[WhisperConfig] = None,
                 device=None) -> tuple:
    """(WhisperEncoder, WhisperDecoder) in eval mode on `device` from an HF
    `WhisperModel` state dict, bare or under `model.` (a
    `WhisperForConditionalGeneration` one); `cfg` defaults to small.en, as
    the JAX transcriber's does. Keys the modules lack (HF's stored
    `encoder.embed_positions.weight`, `proj_out.weight`) are ignored."""
    from hirest_tpu_torch.models.convert import _sub_state_dict, load_into

    cfg = cfg or WhisperConfig()
    if any(k.startswith("model.") for k in sd):
        sd = _sub_state_dict(sd, "model.")
    with torch.device("meta"):
        encoder, decoder = WhisperEncoder(cfg), WhisperDecoder(cfg)
    load_into(encoder, _sub_state_dict(sd, "encoder."), "whisper encoder")
    load_into(decoder, _sub_state_dict(sd, "decoder."), "whisper decoder")
    # the sinusoid buffer is not in the state dict: rebuild it off meta
    encoder.positions = torch.from_numpy(sinusoids(cfg.max_source_positions,
                                                   cfg.d_model))
    return encoder.to(device).eval(), decoder.to(device).eval()
