"""Batched fixed-width beam search on torch tensors.

Counterpart of hirest_tpu/infer/beam.py, whose `lax.scan` programs become
loops of `max_words` steps over device tensors (no host round trip inside
the loop). The selection semantics are the JAX package's, which replace
the reference's per-instance `Beam` objects (clip4caption/modules/beam.py:
31-123) with a static [B, beam] program:

- the scores are seeded [0, -1e18, ...], so the generic
  `scores[:, None] + log_probs` update reproduces the reference's
  first-step special case (beam.py:75-78);
- a `done` flag freezes an instance the first time its TOP beam emits EOS
  (beam.py:88-90);
- hypotheses stay in score-sorted slot order (`torch.topk(sorted=True)`,
  as `jax.lax.top_k`), so slot 0 is the best;
- in the cached search a finished instance gathers its caches by the
  identity, so they stay aligned with its frozen sequences.

`beam_search` re-runs the decoder over the full fixed-length prefix each
step; `beam_search_cached` feeds it only the newest token.
"""

from __future__ import annotations

from typing import Callable

import torch

NEG_INF = -1e18


def _init(b: int, k: int, length: int, bos_id: int, device):
    seqs = torch.zeros(b, k, length + 1, dtype=torch.long, device=device)
    seqs[:, :, 0] = bos_id
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    return seqs, scores, torch.zeros(b, dtype=torch.bool, device=device)


def _select(seqs, scores, logits, t: int):
    """One step's top-k over beam x vocabulary: (the sequences extended,
    their scores, the source slot of each)."""
    b, k, _ = seqs.shape
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    vocab = log_probs.shape[-1]
    beam_lk = scores[:, :, None] + log_probs.reshape(b, k, vocab)
    best_scores, best_ids = beam_lk.reshape(b, k * vocab).topk(
        k, dim=1, sorted=True)
    prev_k = best_ids // vocab
    new_seqs = seqs.gather(1, prev_k[:, :, None].expand_as(seqs)).clone()
    new_seqs[:, :, t + 1] = best_ids - prev_k * vocab
    return new_seqs, best_scores, prev_k


def _freeze(seqs, scores, done, new_seqs, new_scores, t: int, eos_id: int):
    keep = done[:, None]
    seqs = torch.where(keep[:, :, None], seqs, new_seqs)
    scores = torch.where(keep, scores, new_scores)
    return seqs, scores, done | (seqs[:, 0, t + 1] == eos_id)


def beam_search(logits_fn: Callable, batch_size: int, beam_size: int,
                max_words: int, bos_id: int, eos_id: int, *, device):
    """Beam search re-decoding the full prefix each step.

    logits_fn: (ids [B*beam, L+1], t) -> next-token logits [B*beam, V] at
    position t (the logits of token t+1 given ids[:, :t+1]), called with
    t = 0 .. max_words-1.

    Returns (best_ids [B, max_words], best_scores [B]): each instance's best
    hypothesis without BOS (zero-filled after EOS)."""
    b, k, length = batch_size, beam_size, max_words
    seqs, scores, done = _init(b, k, length, bos_id, device)
    for t in range(length):
        logits = logits_fn(seqs.reshape(b * k, length + 1), t)
        new_seqs, new_scores, _ = _select(seqs, scores, logits, t)
        seqs, scores, done = _freeze(seqs, scores, done, new_seqs,
                                     new_scores, t, eos_id)
    return seqs[:, 0, 1:], scores[:, 0]


def beam_search_cached(step_fn: Callable, gather_state_fn: Callable,
                       init_state, batch_size: int, beam_size: int,
                       max_words: int, bos_id: int, eos_id: int, *, device):
    """KV-cached beam search: `beam_search`'s selection, with the decoder
    seeing only the newest token a step.

    step_fn: (last_tokens [B*beam], t, state) -> (logits [B*beam, V],
    state), t the position of last_tokens (0 = BOS).
    gather_state_fn: (state, src_rows [B*beam]) -> the state reordered
    along the flat beam axis, applied after each top-k so the caches follow
    their hypotheses.

    Returns (best_ids [B, max_words], best_scores [B])."""
    b, k, length = batch_size, beam_size, max_words
    seqs, scores, done = _init(b, k, length, bos_id, device)
    state = init_state
    identity = torch.arange(k, device=device)[None].expand(b, k)
    offsets = torch.arange(b, device=device)[:, None] * k
    for t in range(length):
        logits, state = step_fn(seqs.reshape(b * k, length + 1)[:, t], t,
                                state)
        new_seqs, new_scores, prev_k = _select(seqs, scores, logits, t)
        src = torch.where(done[:, None], identity, prev_k)
        state = gather_state_fn(state, (src + offsets).reshape(b * k))
        seqs, scores, done = _freeze(seqs, scores, done, new_seqs,
                                     new_scores, t, eos_id)
    return seqs[:, 0, 1:], scores[:, 0]
