"""The check of the EVA extraction system: each finished video's feature
rows, and a sample of its frames against the plain reference.

The numbers compared, each against the configuration file's limit:

- `rows_wrong`: videos whose features are not [frames, embed_dim] finite
  rows of unit norm (an exact comparison: limit 0);
- `excess_gap`: over a sample of the window's frames drawn from the seed,
  the distance between the program's unit feature and the reference's
  (computed anew from the same weights and frames) beyond the
  configuration's per-frame tolerance `frame_tolerance`, summed over the
  sample. Rounding leaves a few frames a little past the tolerance; a
  lower precision moves most frames past it, and one wrong answer alone
  lies about 1.4 past it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.records import Verdict
from portbench.references.eva_clip_vision import Reference, feature_gaps
from portbench.systems import eva_extract

NORM_SLACK = 1e-3  # a feature row's norm may differ from 1 by this


def rows_wrong(videos, embed_dim: int) -> int:
    bad = 0
    for v in videos:
        f = v.feats
        if (f.shape != (v.n, embed_dim) or not np.isfinite(f).all()
                or np.abs(np.linalg.norm(f, axis=-1) - 1).max() > NORM_SLACK):
            bad += 1
    return bad


def sample(videos, count: int, seed: int) -> list:
    """(video index, frame) pairs drawn from the seed: the last frame of up
    to half `count` videos (the end of a padded batch), the rest uniform
    over every frame the window finished."""
    rng = np.random.default_rng(inputs.stream(seed, "sample"))
    lasts = rng.permutation(len(videos))[:count // 2]
    picks = [(int(i), videos[i].n - 1) for i in lasts]
    ends = np.cumsum([v.n for v in videos])
    rest = min(count - len(picks), int(ends[-1]))
    for f in rng.choice(int(ends[-1]), rest, replace=False):
        i = int(np.searchsorted(ends, f, side="right"))
        picks.append((i, int(f - (ends[i - 1] if i else 0))))
    return picks


def sample_frames(videos, picks, pool: np.ndarray) -> np.ndarray:
    return pool[[eva_extract.frame_indices(videos[i].offset, videos[i].n,
                                           len(pool))[j] for i, j in picks]]


def reference_features(cfg: dict, seed: int, frames: np.ndarray, device,
                       qmax=None) -> torch.Tensor:
    """The reference's unit features of `frames`, on weights made anew from
    the seed."""
    sd = eva_extract.make_weights(cfg, seed, device)
    ref = Reference(sd, cfg, qmax=qmax)
    return ref.features(torch.from_numpy(frames).to(device))


def frame_gaps(videos, picks, pool: np.ndarray, cfg: dict, seed: int,
               device) -> np.ndarray:
    """The distance of each picked frame's feature from the reference's (inf
    where a video's features are not its rows)."""
    want = reference_features(cfg, seed, sample_frames(videos, picks, pool),
                              device, cfg["check"]["reference_qmax"])
    embed = cfg["embed_dim"]
    got = torch.from_numpy(np.stack([
        videos[i].feats[j] if videos[i].feats.shape == (videos[i].n, embed)
        else np.full(embed, np.nan, np.float32) for i, j in picks]))
    gaps = feature_gaps(got.to(device), want).nan_to_num(nan=float("inf"))
    return gaps.cpu().numpy()


def excess(gaps: np.ndarray, tolerance: float) -> float:
    return float(np.clip(gaps - tolerance, 0.0, None).sum())


def verdict(videos, pool: np.ndarray, cfg: dict, seed: int,
            device) -> Verdict:
    """The numbers compared with their limits, the videos whose rows are
    wrong, and the sample's per-frame gaps."""
    chk = cfg["check"]
    limits = chk["limits"]
    gaps = frame_gaps(videos, sample(videos, chk["frames"], seed), pool, cfg,
                      seed, device)
    bad = rows_wrong(videos, cfg["embed_dim"])
    return Verdict({"rows_wrong": (bad, limits["rows_wrong"]),
                    "excess_gap": (excess(gaps, chk["frame_tolerance"]),
                                   limits["excess_gap"])},
                   failed=bad, detail={"gaps": gaps.tolist()})
