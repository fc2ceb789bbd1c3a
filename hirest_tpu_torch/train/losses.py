"""Task losses, parity with the reference training steps.

Counterpart of hirest_tpu/train/losses.py, op for op in f32:

- moment retrieval: BCE-with-logits against one-hot start/end targets,
  moment-masked, normalized by mask mass (modeling.py:249-264);
- moment segmentation: frame-classification CE with out-of-moment logits
  forced to -float32.max, not -inf (modeling.py:339-345);
- step captioning: token CE over ALL max_words positions, the zero
  padding included: the reference's CrossEntropyLoss(ignore_index=-1) on
  0-padded targets counts the [PAD] positions (clip4caption/modules/
  modeling.py:140, modeling.py:519-521).

Each takes an optional `batch_mask` [B]: rows padded onto a batch drop out,
and the real rows are normalized as if they were the whole batch. And an
optional `total`, applied to each denominator before its floor of 1: a
data-parallel rank holds a share of the batch, and `total` sums the share's
denominator over the data group, so that the ranks' losses (and their
gradients) sum to the whole batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32_MAX = torch.finfo(torch.float32).max


def _total(x: torch.Tensor, total) -> torch.Tensor:
    return x if total is None else total(x.detach())


def _row_weight(batch_size: int, batch_mask, device) -> torch.Tensor:
    if batch_mask is None:
        return torch.ones(batch_size, dtype=torch.float32, device=device)
    return batch_mask.float()


def moment_retrieval_loss(start_logits, end_logits, start_target, end_target,
                          moment_mask, batch_mask=None,
                          total=None) -> torch.Tensor:
    b, t = start_logits.shape
    rows = _row_weight(b, batch_mask, start_logits.device)[:, None]
    mask = moment_mask.float() * rows

    def bce(logits, target):
        # max(x, 0) - x*y + log(1 + exp(-|x|)), the stable BCE-with-logits
        x = logits.float()
        y = F.one_hot(target.long(), t).float()
        return x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))

    denom = _total(mask.sum(), total).clamp_min(1.0)
    start_loss = (bce(start_logits, start_target) * mask).sum() / denom
    end_loss = (bce(end_logits, end_target) * mask).sum() / denom
    return (start_loss + end_loss) / 2


def moment_segmentation_loss(seg_logits, target, moment_mask,
                             batch_mask=None, total=None) -> torch.Tensor:
    x = torch.where(moment_mask > 0, seg_logits.float(), -F32_MAX)
    logp = torch.log_softmax(x, dim=-1)
    nll = -logp.gather(1, target.long()[:, None])[:, 0]
    rows = _row_weight(seg_logits.shape[0], batch_mask, seg_logits.device)
    return (nll * rows).sum() / _total(rows.sum(), total).clamp_min(1.0)


def step_captioning_loss(decoder_logits, output_ids, batch_mask=None,
                         total=None) -> torch.Tensor:
    """Mean CE over every (batch, position) cell, PAD positions included."""
    b, length, _ = decoder_logits.shape
    logp = torch.log_softmax(decoder_logits.float(), dim=-1)
    nll = -logp.gather(-1, output_ids.long()[..., None])[..., 0]  # [B, L]
    rows = _row_weight(b, batch_mask, decoder_logits.device)[:, None]
    return ((nll * rows).sum()
            / _total((rows * length).sum(), total).clamp_min(1.0))
