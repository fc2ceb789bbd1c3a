"""Iterative moment-segmentation inference.

Counterpart of hirest_tpu/infer/segmentation.py, with parity to reference
modeling.py:353-474 (`test_moment_segmentation`): up to `max_iterations`
rounds of (scoring forward -> greedy peak expansion -> mask update), then
the reference's exact post-processing (sort, flatten, clip to the moment
end, dedup, enforce >= 5-frame gaps).

`postprocess_boundaries` and `iterative_segmentation` are copies of the
JAX package's host code: the expansion is scalar work on the host, one
fetch of the scores an iteration. `iterative_segmentation_scan` is the
`fused_segmentation` variant: the whole loop as device ops, with one host
fetch at the end.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def postprocess_boundaries(pairs_per_row, starts, lasts) -> list[list[int]]:
    """The reference's exact boundary post-processing (modeling.py:435-464):
    prepend [start,start], append [last,last], sort by segment start,
    flatten, pop trailing bounds beyond the moment end, dedup, and keep only
    boundaries >= 5 frames apart (the final element is excluded from the
    min-gap loop — reference behavior)."""
    results: list[list[int]] = []
    for i, pairs in enumerate(pairs_per_row):
        preds = [[starts[i], starts[i]]] + [list(p) for p in pairs]
        preds.append([lasts[i], lasts[i]])
        preds.sort(key=lambda x: x[0])

        flat: list[int] = []
        for x in preds:
            flat.extend(x)
        while flat and flat[-1] > lasts[i]:
            flat.pop(-1)
        flat = sorted(set(flat))

        kept = [flat[0]]
        current = flat[0]
        for j in range(1, len(flat) - 1):
            if flat[j] - current >= 5:
                kept.append(flat[j])
                current = flat[j]
        results.append(kept)
    return results


def iterative_segmentation(
    score_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    moment_bound_frames: np.ndarray,
    n_frames: int,
    percent_threshold: float = 0.50,
    max_iterations: int = 20,
) -> list[list[int]]:
    """Run the iterative boundary decoding loop.

    Args:
      score_fn: (moment_mask [B,T] int32, prev_boundary_mask [B,T] int32)
        -> softmax scores [B,T] float (already moment-masked + softmaxed,
        matching modeling.py:393-395).
      moment_bound_frames: [B, 2] int array of (start, end) frame indices.
      n_frames: T, the padded/bucketed frame count.
      percent_threshold: --moment_segmentation_difference_threshold.
      max_iterations: --moment_segmentation_max_iterations.

    Returns:
      Per-instance sorted boundary frame lists (the reference's
      `step_predictions`, post-processed).
    """
    bounds = np.asarray(moment_bound_frames)
    b = bounds.shape[0]
    starts = bounds[:, 0].tolist()
    lasts = bounds[:, 1].tolist()

    moment_mask = np.zeros((b, n_frames), dtype=np.int32)
    prev_boundary_mask = np.zeros((b, n_frames), dtype=np.int32)
    for i in range(b):
        moment_mask[i, starts[i]: lasts[i] + 1] = 1
        prev_boundary_mask[i, starts[i]] = 1

    step_predictions: list[list[list[int]]] = [[] for _ in starts]

    for _ in range(max_iterations):
        scores_batch = np.asarray(score_fn(moment_mask, prev_boundary_mask))
        max_frame_idxs = scores_batch.argmax(axis=1)

        for i in range(b):
            scores = scores_batch[i].tolist()
            max_idx = int(max_frame_idxs[i])
            max_score = scores[max_idx]
            if max_score < 0.00001:
                continue

            left_bound = max_idx
            right_bound = max_idx
            while (scores[left_bound] / max_score) > percent_threshold:
                if left_bound == 0:
                    break
                left_bound -= 1
            while (scores[right_bound] / max_score) > percent_threshold:
                if right_bound == (len(scores) - 1):
                    break
                right_bound += 1

            if left_bound == 0 or right_bound == 0:
                continue

            moment_mask[i, left_bound: right_bound + 1] = 0
            prev_boundary_mask[i, left_bound] = 1
            prev_boundary_mask[i, right_bound] = 1
            step_predictions[i].append([left_bound, right_bound])

    return postprocess_boundaries(step_predictions, starts, lasts)


def iterative_segmentation_scan(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    moment_bound_frames: np.ndarray,
    n_frames: int,
    percent_threshold: float = 0.50,
    max_iterations: int = 20,
    *,
    device: torch.device,
) -> list[list[int]]:
    """The loop of `iterative_segmentation` as device ops on `device`, with
    one host fetch at the end (the JAX package's `lax.scan` variant).

    `score_fn(moment_mask, prev_boundary_mask)` takes and returns [B, T]
    tensors on `device` (softmax scores). The greedy walk is vectorized:
    walking down (up) from the argmax until the score ratio drops is "the
    nearest index at or below (at or above) the peak whose ratio <=
    threshold", a masked max (min) over an iota. Same skip conditions and
    the same one-frame overshoot as the host loop; the ratios are f32 where
    the host loop's are float64, as in the JAX variant.
    """
    bounds = np.asarray(moment_bound_frames)
    b = bounds.shape[0]
    starts = torch.as_tensor(bounds[:, 0], device=device)[:, None]
    lasts = torch.as_tensor(bounds[:, 1], device=device)[:, None]
    ids = torch.arange(n_frames, device=device)[None, :]
    mm = ((ids >= starts) & (ids <= lasts)).int()
    pbm = (ids == starts).int()

    steps = []
    for _ in range(max_iterations):
        scores = score_fn(mm, pbm)
        max_idx = scores.argmax(dim=1)[:, None]
        max_score = scores.gather(1, max_idx)
        not_ok = scores / max_score.clamp_min(1e-30) <= percent_threshold

        left = torch.where(not_ok & (ids <= max_idx), ids, -1).amax(1)
        left = left.clamp_min(0)                  # walked to 0 while ok
        right = torch.where(not_ok & (ids >= max_idx), ids, n_frames).amin(1)
        right = right.clamp_max(n_frames - 1)

        upd = ~((max_score[:, 0] < 0.00001) | (left == 0) | (right == 0))
        in_seg = (ids >= left[:, None]) & (ids <= right[:, None])
        mm = torch.where(upd[:, None] & in_seg, 0, mm)
        is_edge = (ids == left[:, None]) | (ids == right[:, None])
        pbm = torch.where(upd[:, None] & is_edge, 1, pbm)
        steps.append(torch.stack([left, right, upd.long()], dim=1))

    steps = torch.stack(steps).cpu().numpy()      # [iter, B, 3], one fetch
    per_row = [[steps[t, i, :2].tolist() for t in range(max_iterations)
                if steps[t, i, 2]] for i in range(b)]
    return postprocess_boundaries(per_row, bounds[:, 0].tolist(),
                                  bounds[:, 1].tolist())
