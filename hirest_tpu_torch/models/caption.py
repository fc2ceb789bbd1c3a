"""CLIP4Caption-style visual encoder and caption decoder in PyTorch.

Counterpart of hirest_tpu/models/caption.py (flax), with the same
arithmetic and the reference's parameter names
(clip4caption/modules/module_visual.py and module_decoder.py), so the
`clip4cap_model.visual.*` and `clip4cap_model.decoder.*` parts of a joint
checkpoint load with `load_state_dict`:

- `VisualEncoder`: Linear(feature -> hidden) embedding + learned positions
  + LayerNorm(1e-12), then BERT-style post-LN self-attention layers over
  every frame (the reference's encoder mask is a constant, so no frame mask
  is applied; modeling.py:208).
- `CaptionDecoder`: BERT-embedding decoder with causal self-attention,
  cross-attention to the encoder output, erf-GELU MLP and a classifier
  tied to the word-embedding table; `decode_step` is the KV-cached
  one-token path of the beam search.

Parameters stay f32; each module computes in its `dtype` as the flax
modules do (`dense` and `layer_norm_fast_var` of models/layers.py). The
attention is the plain `dot_product_attention`: the JAX caption stack
never reaches a Pallas kernel, and neither does this one.

Dropout (rate 0.1) sits where the JAX modules put it, and only there: after
the encoder's embedding LayerNorm and after the decoder's in the
teacher-forced forward (not in `decode_step`). It is live in `train()`
mode only, drawn from the `torch.Generator` that the trainer hands each
`Dropout` module; in `eval()` mode every forward is deterministic.

Under tensor parallelism (parallel/tp.py) the attention takes its local
head count from its q weight's rows, the KV caches their local width from
the k weight's, and the tied classifier gathers the vocabulary's logits
before its bias.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hirest_tpu_torch.config import DecoderConfig, VisualEncoderConfig
from hirest_tpu_torch.models.layers import (MultiHeadAttention, dense,
                                            dot_product_attention, gelu_erfc,
                                            layer_norm_fast_var, merge_heads,
                                            split_heads)


class Dropout(nn.Module):
    """flax nn.Dropout: in training, keep each value with probability
    1 - rate and scale it by 1 / (1 - rate), else 0; the identity in
    eval mode. The keep mask comes from `generator` (the default
    generator when None), on x's device.

    `rows` = (first, n): x holds rows first.. of a batch whose first n rows
    are real (a data-parallel rank's share of a padded batch). The mask is
    then drawn for the n real rows, as one process drawing for the real
    batch draws it, and this rank keeps its rows of it (its rows past n,
    padding, keep everything)."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.rows: Optional[tuple] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if self.rows is None:
            draw = torch.rand(x.shape, generator=self.generator,
                              device=x.device)
        else:
            first, n = self.rows
            draw = torch.rand((n, *x.shape[1:]), generator=self.generator,
                              device=x.device)[first:first + x.shape[0]]
            draw = torch.cat([draw, draw.new_zeros(
                (x.shape[0] - draw.shape[0], *x.shape[1:]))])
        keep = draw < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """{0, 1} mask -> the reference's additive bias, (mask) * -10000 in f32."""
    return mask.float() * -10000.0


class BertSelfOutput(nn.Module):
    """dense -> residual add -> LayerNorm (post-LN)."""

    def __init__(self, in_dim: int, out_dim: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(in_dim, out_dim)
        self.LayerNorm = nn.LayerNorm(out_dim, eps=eps)

    def forward(self, hidden: torch.Tensor,
                residual: torch.Tensor) -> torch.Tensor:
        return layer_norm_fast_var(dense(hidden, self.dense) + residual,
                                   self.LayerNorm)


class BertFfn(nn.Module):
    """The erf-GELU feed-forward with its post-LN residual, as the base of a
    layer so that its parameters carry the reference's layer-level names
    (`intermediate.dense`, `output.dense`, `output.LayerNorm`)."""

    def __init__(self, hidden: int, intermediate_size: int, eps: float):
        super().__init__()
        self.intermediate = nn.ModuleDict(
            {"dense": nn.Linear(hidden, intermediate_size)})
        self.output = BertSelfOutput(intermediate_size, hidden, eps)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(gelu_erfc(dense(x, self.intermediate["dense"])), x)


class VisualLayer(BertFfn):
    def __init__(self, hidden: int, heads: int, intermediate_size: int,
                 eps: float):
        super().__init__(hidden, intermediate_size, eps)
        self.attention = nn.ModuleDict({
            "self": MultiHeadAttention(hidden, heads, hidden // heads,
                                       mode="separate"),
            "output": BertSelfOutput(hidden, hidden, eps)})

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        att = self.attention["self"](x, bias)
        return self.ffn(self.attention["output"](att, x))


class VisualEncoder(nn.Module):
    """[B, T, in_dim] frame features -> [B, T, hidden] contextual
    embeddings in `dtype`. `in_dim` defaults to the config's feature_dim;
    the joint model passes its trunk width, which is what the flax Dense
    infers from its input."""

    def __init__(self, config: VisualEncoderConfig = VisualEncoderConfig(),
                 dtype: torch.dtype = torch.float32,
                 in_dim: Optional[int] = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Linear(in_dim or cfg.feature_dim,
                                         cfg.hidden_size),
            "position_embeddings": nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size),
            "LayerNorm": nn.LayerNorm(cfg.hidden_size, eps=cfg.norm_eps)})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            VisualLayer(cfg.hidden_size, cfg.num_attention_heads,
                        cfg.intermediate_size, cfg.norm_eps)
            for _ in range(cfg.num_hidden_layers))})
        self.dropout = Dropout()

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        cfg, emb = self.config, self.embeddings
        t = feats.shape[1]
        if t > cfg.max_position_embeddings:
            raise ValueError(f"sequence {t} exceeds position table "
                             f"{cfg.max_position_embeddings}")
        x = dense(feats.to(self.dtype), emb["word_embeddings"])
        x = x + emb["position_embeddings"].weight[:t].to(self.dtype)
        x = self.dropout(layer_norm_fast_var(x, emb["LayerNorm"]))
        for layer in self.encoder["layer"]:
            x = layer(x)
        return x


class AttnProj(nn.Module):
    """The q/k/v projections of a decoder attention (reference `att`),
    exposed apart so the KV-cached path can reuse the k/v weights."""

    def __init__(self, inner: int):
        super().__init__()
        self.query = nn.Linear(inner, inner)
        self.key = nn.Linear(inner, inner)
        self.value = nn.Linear(inner, inner)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor):
        return (dense(q_in, self.query), dense(kv_in, self.key),
                dense(kv_in, self.value))


class DecoderLayer(BertFfn):
    def __init__(self, heads: int, hidden_size: int, intermediate_size: int,
                 eps: float):
        super().__init__(hidden_size, intermediate_size, eps)
        self.heads, self.hidden_size = heads, hidden_size
        self.slf_attn = nn.ModuleDict({
            "att": AttnProj(hidden_size),
            "output": BertSelfOutput(hidden_size, hidden_size, eps)})
        self.enc_attn = nn.ModuleDict({
            "att": AttnProj(hidden_size),
            "output": BertSelfOutput(hidden_size, hidden_size, eps)})

    def _attend(self, q, k, v, bias):
        d = self.hidden_size // self.heads
        h = q.shape[-1] // d  # the local heads under tensor parallelism
        scale = d ** -0.5
        return merge_heads(dot_product_attention(
            split_heads(q, h), split_heads(k, h), split_heads(v, h), bias,
            scale))

    def forward(self, x, encoder_out, self_bias, cross_bias=None):
        q, k, v = self.slf_attn["att"](x, x)
        x = self.slf_attn["output"](self._attend(q, k, v, self_bias), x)
        q, k, v = self.enc_attn["att"](x, encoder_out)
        x = self.enc_attn["output"](self._attend(q, k, v, cross_bias), x)
        return self.ffn(x)

    def step(self, x, pos: int, enc_k, enc_v, cache_k, cache_v):
        """One-token decode: x [N, 1, H] at position `pos`, enc_{k,v} the
        precomputed cross-attention projections [N, T, H], cache_{k,v}
        [N, L, H] the self-attention caches, whose slot `pos` this writes in
        place. Returns (y [N, 1, H], cache_k, cache_v)."""
        q, k, v = self.slf_attn["att"](x, x)
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
        # mask the cache slots past pos (causal over the filled prefix)
        keys = torch.arange(cache_k.shape[1], device=x.device)
        bias = attention_bias(keys > pos)
        x = self.slf_attn["output"](self._attend(q, cache_k, cache_v, bias),
                                    x)
        q = dense(x, self.enc_attn["att"].query)
        x = self.enc_attn["output"](self._attend(q, enc_k, enc_v, None), x)
        return self.ffn(x), cache_k, cache_v

    def cross_kv(self, encoder_out):
        att = self.enc_attn["att"]
        return dense(encoder_out, att.key), dense(encoder_out, att.value)


class Predictions(nn.Module):
    """The classifier head (reference `classifier.cls.predictions`): a
    transform (dense, erf GELU, LayerNorm) and the vocabulary bias; its
    weight is the decoder's word-embedding table."""

    def __init__(self, hidden: int, vocab: int, eps: float):
        super().__init__()
        self.transform = nn.ModuleDict({
            "dense": nn.Linear(hidden, hidden),
            "LayerNorm": nn.LayerNorm(hidden, eps=eps)})
        self.bias = nn.Parameter(torch.zeros(vocab))


class CaptionDecoder(nn.Module):
    """Teacher-forced decode: token ids [B, L] + encoder outputs [B, T, H]
    -> vocabulary logits [B, L, V] f32 (module_decoder.py:112-406).

    `decode_step` is the KV-cached single-token path of the beam search:
    the cross-attention K/V are projected once a sequence (`cross_kv`), the
    self-attention K/V accumulate in fixed [N, L, H] caches (`init_cache`).

    Token ids past the vocabulary read its last row, as JAX's clamped gather
    does (a vocabulary smaller than the default BOS/EOS ids 101/102 is
    legal there)."""

    def __init__(self, config: DecoderConfig = DecoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(cfg.vocab_size, cfg.hidden_size),
            "position_embeddings": nn.Embedding(cfg.max_target_embeddings,
                                                cfg.hidden_size),
            "LayerNorm": nn.LayerNorm(cfg.hidden_size, eps=cfg.norm_eps)})
        self.decoder = nn.ModuleDict({"layer": nn.ModuleList(
            DecoderLayer(cfg.num_attention_heads, cfg.hidden_size,
                         cfg.intermediate_size, cfg.norm_eps)
            for _ in range(cfg.num_decoder_layers))})
        self.classifier = nn.ModuleDict({"cls": nn.ModuleDict({
            "predictions": Predictions(cfg.hidden_size, cfg.vocab_size,
                                       cfg.norm_eps)})})
        self.dropout = Dropout()

    @property
    def layers(self):
        return self.decoder["layer"]

    def _embed(self, ids: torch.Tensor, positions) -> torch.Tensor:
        emb = self.embeddings
        words = emb["word_embeddings"]
        ids = ids.long().clamp(0, words.num_embeddings - 1)
        x = (words(ids) if getattr(words, "tensor_parallel", False)
             else words.weight[ids]).to(self.dtype)
        x = x + emb["position_embeddings"].weight[positions].to(self.dtype)
        return layer_norm_fast_var(x, emb["LayerNorm"])

    def _classify(self, h: torch.Tensor) -> torch.Tensor:
        head = self.classifier["cls"]["predictions"]
        h = gelu_erfc(dense(h, head.transform["dense"]))
        h = layer_norm_fast_var(h, head.transform["LayerNorm"])
        words = self.embeddings["word_embeddings"]
        if getattr(words, "tensor_parallel", False):
            logits = words.logits(h)
        else:
            logits = h @ words.weight.to(self.dtype).T
        return (logits + head.bias.to(self.dtype)).float()

    def forward(self, input_ids: torch.Tensor, encoder_out: torch.Tensor,
                answer_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        length = input_ids.shape[1]
        x = self.dropout(self._embed(input_ids, slice(0, length)))
        # the reference's mask (module_decoder.py:389-396): causal triu OR'd
        # with the inverted answer mask, then scaled by -10000
        ones = torch.ones(length, length, device=x.device)
        self_mask = ones.triu(1)[None, None]
        if answer_mask is not None:
            inv = (1.0 - answer_mask.float())[:, None, None, :]
            self_mask = torch.clamp_max(inv + self_mask, 1.0)
        self_bias = attention_bias(self_mask)
        for layer in self.layers:
            x = layer(x, encoder_out, self_bias)
        return self._classify(x)

    # -- KV-cached decoding ------------------------------------------------

    def init_cache(self, batch: int, max_len: int):
        width = self.layers[0].slf_attn["att"].key.weight.shape[0]
        shape = (batch, max_len, width)
        device = self.embeddings["word_embeddings"].weight.device
        return tuple((torch.zeros(shape, dtype=self.dtype, device=device),
                      torch.zeros(shape, dtype=self.dtype, device=device))
                     for _ in self.layers)

    def cross_kv(self, encoder_out: torch.Tensor):
        return tuple(layer.cross_kv(encoder_out) for layer in self.layers)

    def decode_step(self, tok_ids: torch.Tensor, pos: int, cross_kv, cache):
        """tok_ids [N] at position `pos` -> (logits [N, V], cache); the
        caches' slot `pos` is written in place."""
        x = self._embed(tok_ids[:, None], slice(pos, pos + 1))
        new_cache = []
        for layer, (enc_k, enc_v), (ck, cv) in zip(self.layers, cross_kv,
                                                   cache):
            x, ck, cv = layer.step(x, pos, enc_k, enc_v, ck, cv)
            new_cache.append((ck, cv))
        return self._classify(x)[:, 0], tuple(new_cache)
