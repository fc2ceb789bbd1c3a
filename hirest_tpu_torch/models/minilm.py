"""MiniLM sentence encoder in PyTorch (all-MiniLM-L6-v2 family).

Counterpart of hirest_tpu/models/minilm.py (flax). The reference embeds ASR
subtitle segments with sentence-transformers all-MiniLM-L6-v2 (384-d;
extraction/whisper_ASR/extract_ASR_embedding.py): a standard HF BERT
encoder (6 layers, hidden 384, 12 heads, intermediate 1536), then
attention-mask mean pooling and L2 normalization.

The layers are the port's BERT post-LN layer (`caption.VisualLayer`:
`layers.MultiHeadAttention` in its q/k/v mode without an output
projection, `caption.BertSelfOutput`, `caption.BertFfn` with the erf GELU),
as the JAX encoder builds on its own caption stack, with HF `BertModel`
parameter names, so an HF or sentence-transformers checkpoint loads with
`load_state_dict` (`convert_minilm` strips its prefix). The LayerNorms are
flax's arithmetic (`layer_norm_fast_var`, eps 1e-12), the additive mask
-10000.

Tokenization uses the WordPiece tokenizer (same vocab.txt as BERT-uncased).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from hirest_tpu_torch.models.caption import VisualLayer, attention_bias
from hirest_tpu_torch.models.layers import layer_norm_fast_var


@dataclass(frozen=True)
class MiniLmConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12


class MiniLmEncoder(nn.Module):
    """token ids + attention mask [B, L] -> mean-pooled normalized [B, H]
    (f32), or the last hidden states [B, L, H] with pool=False."""

    def __init__(self, config: MiniLmConfig = MiniLmConfig()):
        super().__init__()
        cfg = self.config = config
        h = cfg.hidden_size
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(cfg.vocab_size, h),
            "position_embeddings": nn.Embedding(cfg.max_position_embeddings,
                                                h),
            "token_type_embeddings": nn.Embedding(cfg.type_vocab_size, h),
            "LayerNorm": nn.LayerNorm(h, eps=cfg.norm_eps)})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            VisualLayer(h, cfg.num_attention_heads, cfg.intermediate_size,
                        cfg.norm_eps)
            for _ in range(cfg.num_hidden_layers))})

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pool: bool = True,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        emb = self.embeddings
        length = input_ids.shape[1]
        x = emb["word_embeddings"].weight[input_ids.long()]
        types = emb["token_type_embeddings"].weight
        # single-sentence callers keep the all-zeros segment (row 0)
        seg = types[0] if token_type_ids is None else types[
            token_type_ids.long()]
        x = x + emb["position_embeddings"].weight[:length] + seg
        x = layer_norm_fast_var(x, emb["LayerNorm"])
        bias = attention_bias(1.0 - attention_mask.float())[:, None, None, :]
        for layer in self.encoder["layer"]:
            x = layer(x, bias)
        if not pool:
            return x
        # sentence-transformers mean pooling + L2 normalize
        m = attention_mask.float()[..., None]
        pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1e-9)
        return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)


def convert_minilm(sd: Mapping) -> dict:
    """HF BertModel state dict (bare or 'bert.'-prefixed, or
    sentence-transformers' '0.auto_model.' prefix) -> MiniLmEncoder's state
    dict (f32 tensors, the prefix stripped; HF's pooler and position-id
    buffer are left for the non-strict load to ignore)."""
    from hirest_tpu_torch.models.convert import _sub_state_dict

    for prefix in ("0.auto_model.", "bert.", ""):
        if any(k.startswith(prefix + "embeddings.") for k in sd):
            return _sub_state_dict(sd, prefix)
    raise KeyError("no BERT `embeddings.*` keys in the MiniLM state dict")


def load_minilm(ckpt, config: MiniLmConfig = MiniLmConfig(),
                device=None) -> MiniLmEncoder:
    """MiniLmEncoder in eval mode on `device` from a checkpoint path or a
    loaded state dict."""
    from hirest_tpu_torch.models.convert import load_into, load_torch_ckpt

    sd = ckpt if isinstance(ckpt, Mapping) else load_torch_ckpt(ckpt)
    with torch.device("meta"):
        model = MiniLmEncoder(config)
    load_into(model, convert_minilm(sd), "MiniLM")
    return model.to(device).eval()


def make_minilm_embedder(ckpt_path, vocab_path: str, max_length: int = 128,
                         config: MiniLmConfig = MiniLmConfig(), device=None):
    """Build a `texts -> [N, 384] normalized embeddings` callable on the
    port's MiniLM on `device` (CUDA unless "cpu" is asked for);
    `ckpt_path` is a checkpoint path or a loaded state dict.

    The batch is padded to a power of two, at least 8, as the JAX embedder
    pads it for its jit (one [cap, max_length] shape per bucket), and pad
    rows get a bare [CLS][SEP] mask: the rows it returns are the rows the
    JAX embedder returns."""
    from hirest_tpu_torch.tokenizers import WordPieceTokenizer
    from hirest_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    tok = WordPieceTokenizer(vocab_path)
    cls_id, sep_id = tok.vocab["[CLS]"], tok.vocab["[SEP]"]
    model = load_minilm(ckpt_path, config, device)

    @torch.inference_mode()
    def embed(texts):
        n = len(texts)
        cap = max(8, 1 << (n - 1).bit_length())
        ids = np.zeros((cap, max_length), np.int32)
        mask = np.zeros((cap, max_length), np.int32)
        for i, text in enumerate(texts):
            toks = [cls_id] + tok.convert_tokens_to_ids(
                tok.tokenize(text))[: max_length - 2] + [sep_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        # pad rows get a bare [CLS][SEP] mask so the row mean is defined
        mask[n:, :2] = 1
        out = model(torch.from_numpy(ids).to(device),
                    torch.from_numpy(mask).to(device))
        return out[:n].cpu().numpy()

    return embed
