"""BERTScore on the port's BERT encoder.

Counterpart of hirest_tpu/eval/bertscore.py. The reference scores captions
with the `bert_score` pip package (evaluate.py:293-297, roberta-large).
This is the published BERTScore algorithm (Zhang et al. 2020): contextual
token embeddings, pairwise cosine, greedy max matching, P/R/F1 per pair,
the mean F1 over pairs; here on `MiniLmEncoder` (any HF BERT-architecture
checkpoint) with pool=False, over the content tokens (no [CLS], [SEP] or
padding). With another encoder than roberta-large the absolute values
differ from the reference's; IDF weighting is off, as bert_score's default.
"""

from __future__ import annotations

import numpy as np


def bertscore_pairs(cand_embs, cand_masks, ref_embs, ref_masks):
    """Greedy-match P/R/F1 for one batch of pairs.

    cand_embs/ref_embs: [N, L, H] contextual embeddings; masks [N, L] with
    special tokens ([CLS]/[SEP]/[PAD]) zeroed.
    """
    c = np.asarray(cand_embs, np.float32)
    r = np.asarray(ref_embs, np.float32)
    cm = np.asarray(cand_masks, bool)
    rm = np.asarray(ref_masks, bool)

    c = c / np.clip(np.linalg.norm(c, axis=-1, keepdims=True), 1e-9, None)
    r = r / np.clip(np.linalg.norm(r, axis=-1, keepdims=True), 1e-9, None)
    sim = np.einsum("nld,nmd->nlm", c, r)
    sim = np.where(cm[:, :, None] & rm[:, None, :], sim, -1.0)

    # precision: each candidate token greedily matches its best ref token;
    # recall: each reference token matches its best candidate token
    precision = np.array([
        sim[i][cm[i]][:, rm[i]].max(axis=1).mean()
        if (cm[i].any() and rm[i].any()) else 0.0
        for i in range(sim.shape[0])])
    recall = np.array([
        sim[i][cm[i]][:, rm[i]].max(axis=0).mean()
        if (cm[i].any() and rm[i].any()) else 0.0
        for i in range(sim.shape[0])])
    # plain 2pr/(p+r), 0 where the denominator vanishes — cosines can be
    # negative, and clipping a NEGATIVE p+r up to epsilon would explode F1
    # to an enormous wrong value instead of the correct negative score
    denom = precision + recall
    f1 = np.where(np.abs(denom) < 1e-9, 0.0,
                  2 * precision * recall / np.where(denom == 0, 1.0, denom))
    return precision, recall, f1


def make_bertscore_fn(ckpt_path, vocab_path: str, max_length: int = 64,
                      config=None, batch_size: int = 32, device=None):
    """Build a `(cands, refs) -> mean F1` callable (the evaluator's
    bertscore_fn plugin surface) on the port's BERT encoder on `device`
    (CUDA unless "cpu" is asked for); `ckpt_path` is a checkpoint path or
    a loaded state dict. `fn.encode(texts) -> (embeddings [N, L, H] f32,
    content mask [N, L])` is the encoder's half."""
    import torch

    from hirest_tpu_torch.models.minilm import MiniLmConfig, load_minilm
    from hirest_tpu_torch.tokenizers import WordPieceTokenizer
    from hirest_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = config or MiniLmConfig()
    tok = WordPieceTokenizer(vocab_path)
    cls_id, sep_id = tok.vocab["[CLS]"], tok.vocab["[SEP]"]
    model = load_minilm(ckpt_path, cfg, device)

    @torch.inference_mode()
    def encode(texts):
        n = len(texts)
        ids = np.zeros((n, max_length), np.int32)
        attn = np.zeros((n, max_length), np.int32)
        content = np.zeros((n, max_length), bool)  # excludes CLS/SEP/PAD
        for i, text in enumerate(texts):
            toks = tok.convert_tokens_to_ids(tok.tokenize(text))[: max_length - 2]
            row = [cls_id] + toks + [sep_id]
            ids[i, : len(row)] = row
            attn[i, : len(row)] = 1
            content[i, 1: 1 + len(toks)] = True
        embs = model(torch.from_numpy(ids).to(device),
                     torch.from_numpy(attn).to(device), pool=False)
        return embs.float().cpu().numpy(), content

    def bertscore(cands, refs):
        f1s = []
        for i in range(0, len(cands), batch_size):
            c_emb, c_mask = encode(list(cands[i: i + batch_size]))
            r_emb, r_mask = encode(list(refs[i: i + batch_size]))
            _, _, f1 = bertscore_pairs(c_emb, c_mask, r_emb, r_mask)
            f1s.extend(f1.tolist())
        return float(np.mean(f1s)) if f1s else 0.0

    bertscore.encode = encode
    return bertscore


def make_hf_entailment_fn(model_dir: str, label_order=("entailment",
                                                       "contradiction",
                                                       "neutral")):
    """Entailment plugin from any local HF NLI sequence-classification
    checkpoint through `transformers` (imported here, on the CPU, at
    evaluation time only; the reference also scores with an external
    entailment model, evaluate.py:197-201). Returns fn(premise, hypothesis)
    -> index into (entail, contradict, neutral)."""
    import torch
    from transformers import (AutoModelForSequenceClassification,
                              AutoTokenizer)

    from hirest_tpu_torch.models.nli import nli_label_remap

    tok = AutoTokenizer.from_pretrained(model_dir)
    model = AutoModelForSequenceClassification.from_pretrained(model_dir).eval()
    remap = nli_label_remap(dict(model.config.id2label), label_order)

    def entailment(premise: str, hypothesis: str) -> int:
        with torch.no_grad():
            inputs = tok(premise, hypothesis, return_tensors="pt",
                         truncation=True, max_length=256)
            logits = model(**inputs).logits[0]
        return remap[int(logits.argmax())]

    return entailment
