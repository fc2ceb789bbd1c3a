"""NLI cross-encoder for the Entailment step-captioning metric, in PyTorch.

Counterpart of hirest_tpu/models/nli.py. The reference scores
Entailment/Contradiction/Neutral with AllenNLP's decomposable-attention
ELMo predictor (reference evaluate.py:197-201, 275-286): argmax over the
SNLI order (entailment, contradiction, neutral). As in the JAX package the
metric is computed by a BERT-architecture NLI cross-encoder with HF
`BertForSequenceClassification` semantics: `[CLS] premise [SEP] hypothesis
[SEP]` with segment ids -> the port's `MiniLmEncoder` -> tanh pooler over
[CLS] -> classifier, from any HF BERT NLI checkpoint (MNLI/SNLI
fine-tunes), its label order remapped to the reference's.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from hirest_tpu_torch.models.minilm import (MiniLmConfig, MiniLmEncoder,
                                            convert_minilm)

# the reference's output order (evaluate.py:283-286: index 0 counts as
# "Entailment", 1 "Contradiction", 2 "Netural")
REFERENCE_LABEL_ORDER = ("entailment", "contradiction", "neutral")


class NliCrossEncoder(nn.Module):
    """(input_ids, attention_mask, token_type_ids) [B, L] -> logits [B, n]
    f32."""

    def __init__(self, config: MiniLmConfig = MiniLmConfig(),
                 num_labels: int = 3):
        super().__init__()
        self.config = config
        self.encoder = MiniLmEncoder(config)
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size)
        self.classifier = nn.Linear(config.hidden_size, num_labels)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        x = self.encoder(input_ids, attention_mask, pool=False,
                         token_type_ids=token_type_ids)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled).float()


def convert_nli(sd: Mapping) -> dict:
    """HF BertForSequenceClassification state dict (`bert.*`, the pooler
    as `bert.pooler.dense` or `pooler.dense`, `classifier`) ->
    NliCrossEncoder's state dict, f32 tensors."""
    from hirest_tpu_torch.models.convert import _f32

    pooler = ("bert.pooler.dense" if "bert.pooler.dense.weight" in sd
              else "pooler.dense")
    out = {f"encoder.{k}": v for k, v in convert_minilm(sd).items()}
    for name, src in (("pooler", pooler), ("classifier", "classifier")):
        out[f"{name}.weight"] = _f32(sd[f"{src}.weight"])
        out[f"{name}.bias"] = _f32(sd[f"{src}.bias"])
    return out


def nli_label_remap(id2label: dict, label_order=REFERENCE_LABEL_ORDER) -> dict:
    """{checkpoint label index -> reference label index}; NLI fine-tunes
    disagree on label order (MNLI's is contradiction/neutral/entailment,
    SNLI fine-tunes vary), so the checkpoint's id2label is authoritative."""
    remap = {}
    for idx, label in id2label.items():
        label = label.lower()
        for j, want in enumerate(label_order):
            if want.startswith(label[:6]) or label.startswith(want[:6]):
                remap[int(idx)] = j
    if len(remap) != len(id2label):
        raise ValueError(f"unmapped NLI labels: {id2label}")
    return remap


def _hf_bert_config(model_dir: str) -> tuple[MiniLmConfig, Optional[dict]]:
    """(MiniLmConfig, id2label or None) from an HF model dir's
    config.json."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    if hf.get("model_type", "bert") != "bert":
        raise ValueError(
            f"the port's NLI path supports BERT-architecture checkpoints; "
            f"got model_type={hf.get('model_type')!r} (the transformers "
            f"plugin make_hf_entailment_fn handles other architectures)")
    cfg = MiniLmConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        norm_eps=hf.get("layer_norm_eps", 1e-12),
    )
    id2label = hf.get("id2label")
    if id2label:
        id2label = {int(k): v for k, v in dict(id2label).items()}
        if all(str(v).lower().startswith("label_") for v in id2label.values()):
            # transformers fills in LABEL_0/LABEL_1/... when the fine-tune
            # never named its labels: that carries no order
            id2label = None
    return cfg, id2label or None


def encode_pair(tok, premise: str, hypothesis: str, max_length: int):
    """BERT pair encoding: [CLS] a [SEP] b [SEP]; segment 1 starts after the
    first [SEP]. Longest-first truncation (HF `truncation='longest_first'`).
    Returns (ids, token types, mask), each int32 [max_length]."""
    cls_id, sep_id = tok.vocab["[CLS]"], tok.vocab["[SEP]"]
    a = tok.convert_tokens_to_ids(tok.tokenize(premise))
    b = tok.convert_tokens_to_ids(tok.tokenize(hypothesis))
    while len(a) + len(b) > max_length - 3:
        (a if len(a) >= len(b) else b).pop()
    ids = [cls_id] + a + [sep_id] + b + [sep_id]
    types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
    n = len(ids)
    out_ids = np.zeros(max_length, np.int32)
    out_types = np.zeros(max_length, np.int32)
    out_mask = np.zeros(max_length, np.int32)
    out_ids[:n], out_types[:n], out_mask[:n] = ids, types, 1
    return out_ids, out_types, out_mask


NLI_CHECKPOINTS = ("model.safetensors", "pytorch_model.bin", "model.bin",
                   "model.pt")
CHUNK = 256  # pairs a forward in `.batch`, as the JAX function chunks them


def load_nli(ckpt, config: MiniLmConfig, num_labels: int,
             device=None) -> NliCrossEncoder:
    """NliCrossEncoder in eval mode on `device` from a checkpoint path
    (`.safetensors` or torch) or a loaded state dict."""
    from hirest_tpu_torch.models.convert import load_into, load_torch_ckpt

    sd = ckpt if isinstance(ckpt, Mapping) else load_torch_ckpt(ckpt)
    with torch.device("meta"):
        model = NliCrossEncoder(config, num_labels)
    load_into(model, convert_nli(sd), "NLI")
    return model.to(device).eval()


def make_nli_entailment_fn(model_dir: str, max_length: int = 128,
                           label_order=REFERENCE_LABEL_ORDER,
                           id2label: Optional[dict] = None, device=None):
    """The evaluator's `entailment_fn` plugin, `fn(premise, hypothesis) ->
    index into (entail, contradict, neutral)`, on the cross-encoder on
    `device` (CUDA unless "cpu" is asked for), from an HF model dir
    (model.safetensors / pytorch_model.bin / model.bin / model.pt +
    config.json + vocab.txt).

    `fn.batch(pairs) -> list[int]`, which the evaluator prefers, scores the
    pairs CHUNK at a time in one forward each. (The JAX function pads
    each chunk to a power-of-two bucket of [CLS][SEP][SEP] rows for its
    jit and drops their logits; every row is scored on its own, so the
    port leaves the padding out.)

    `id2label` overrides the checkpoint's label order for config.jsons
    that carry none; guessing one would silently swap Entailment and
    Contradiction (MNLI's order is contradiction/neutral/entailment, the
    reference's entailment/contradiction/neutral), so absent both this
    raises."""
    from hirest_tpu_torch.tokenizers import WordPieceTokenizer
    from hirest_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg, ckpt_id2label = _hf_bert_config(model_dir)
    if id2label is not None:
        id2label = {int(k): v for k, v in dict(id2label).items()}
    else:
        id2label = ckpt_id2label
    if id2label is None:
        raise ValueError(
            f"{model_dir}/config.json carries no informative id2label and "
            f"none was passed; NLI fine-tunes disagree on class order, so "
            f"guessing would silently swap Entailment and Contradiction. "
            f"Pass id2label=, e.g. "
            f"{{0: 'contradiction', 1: 'neutral', 2: 'entailment'}} (MNLI).")
    remap = nli_label_remap(id2label, label_order)
    ckpt = next((os.path.join(model_dir, n) for n in NLI_CHECKPOINTS
                 if os.path.exists(os.path.join(model_dir, n))), None)
    if ckpt is None:
        raise FileNotFoundError(
            f"no NLI checkpoint in {model_dir}; expected one of "
            f"{NLI_CHECKPOINTS}")
    tok = WordPieceTokenizer(os.path.join(model_dir, "vocab.txt"))
    model = load_nli(ckpt, cfg, len(id2label), device)

    @torch.inference_mode()
    def logits(pairs) -> np.ndarray:
        rows = [encode_pair(tok, p, h, max_length) for p, h in pairs]
        ids, types, mask = (torch.from_numpy(np.stack(col)).to(device)
                            for col in zip(*rows))
        return model(ids, mask, types).cpu().numpy()

    def batch(pairs) -> list:
        out = []
        for lo in range(0, len(pairs), CHUNK):
            out.extend(remap[int(k)]
                       for k in logits(pairs[lo:lo + CHUNK]).argmax(1))
        return out

    def entailment(premise: str, hypothesis: str) -> int:
        return batch([(premise, hypothesis)])[0]

    entailment.batch = batch
    entailment.logits = logits
    return entailment
