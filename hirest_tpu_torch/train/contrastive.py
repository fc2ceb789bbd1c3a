"""Contrastive objectives for caption/retrieval pretraining.

Counterpart of hirest_tpu/train/contrastive.py (reference
clip4caption/modules/until_module.py:182-261: CrossEn, MILNCELoss,
MaxMarginRankingLoss), in f32.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_en(sim_matrix: torch.Tensor) -> torch.Tensor:
    """Row-wise InfoNCE with the diagonal as positives (CrossEn)."""
    logpt = torch.log_softmax(sim_matrix.float(), dim=-1)
    return -torch.diagonal(logpt).mean()


def milnce(sim_matrix: torch.Tensor, batch_size: Optional[int] = None,
           n_pair: int = 1) -> torch.Tensor:
    """MIL-NCE (Miech et al. 2020): the positives are the block-diagonal
    pairs of an [B*n, B*n] similarity matrix; the loss marginalizes over
    the positive set before the softmax."""
    n = sim_matrix.shape[0]
    b = batch_size or n // n_pair
    dev = sim_matrix.device
    labels = torch.kron(torch.eye(b, device=dev),
                        torch.ones(n_pair, n_pair, device=dev))  # [n, n]
    s = sim_matrix.float()
    # row-wise and column-wise candidates side by side, as the standard
    # implementation does
    logits = torch.cat([s, s.T], dim=1)  # [n, 2n]
    mask = torch.cat([labels, torch.eye(n, device=dev)], dim=1)
    pos = torch.where(mask > 0, logits, float("-inf"))
    return (torch.logsumexp(logits, 1) - torch.logsumexp(pos, 1)).mean()


def max_margin_ranking(sim_matrix: torch.Tensor,
                       margin: float = 0.1) -> torch.Tensor:
    """Bidirectional max-margin ranking loss against the diagonal
    positives."""
    s = sim_matrix.float()
    d = torch.diagonal(s)
    row = (margin + s - d[:, None]).clamp_min(0.0)
    col = (margin + s - d[None, :]).clamp_min(0.0)
    n = s.shape[0]
    off = 1.0 - torch.eye(n, device=s.device)
    return ((row * off).sum() + (col * off).sum()) / max(1.0, 2 * n * (n - 1))
