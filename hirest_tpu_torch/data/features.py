"""Feature store: precomputed visual/ASR features -> per-example arrays.

An own copy of hirest_tpu/data/features.py (the port imports nothing of the JAX package).

Replaces the reference's per-__getitem__ `torch.load` of `.pt` files
(hirest_dataset.py:323-407). Supports both `.pt` (torch CPU, offline dep)
and `.npy`/`.npz` feature files, with an in-process LRU cache. The ASR
warping (per-subtitle vectors spread over their [start, end) seconds) and
the linspace-subsample / repeat-upsample resizing both come from the shared
timeline library.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional

import numpy as np

from hirest_tpu_torch import native
from hirest_tpu_torch.data.srt import load_srt
from hirest_tpu_torch.timeline import resample_frames


def _load_feature_file(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return z[list(z.keys())[0]].astype(np.float32)
    # .pt / .bin -> torch (host-side only)
    import torch

    t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(t.detach().float().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


class FeatureStore:
    """Loads visual features keyed by video fname (e.g. 'abc.mp4') and
    warped ASR features keyed by video id ('abc')."""

    def __init__(self, video_feature_dir: Optional[str] = None,
                 asr_dir: Optional[str] = None,
                 asr_feature_dir: Optional[str] = None,
                 cache_size: int = 256):
        self.video_feature_dir = Path(video_feature_dir) if video_feature_dir else None
        self.asr_dir = Path(asr_dir) if asr_dir else None
        self.asr_feature_dir = Path(asr_feature_dir) if asr_feature_dir else None
        if self.video_feature_dir is not None:
            assert self.video_feature_dir.exists(), (
                f"video_feature_dir {self.video_feature_dir} does not exist")
        self._load_visual = functools.lru_cache(maxsize=cache_size)(self._load_visual_impl)
        self._load_asr = functools.lru_cache(maxsize=cache_size)(self._load_asr_impl)

    @property
    def has_asr(self) -> bool:
        return self.asr_dir is not None and self.asr_feature_dir is not None

    def _find(self, directory: Path, stem: str) -> Path:
        for suffix in (".pt", ".npy", ".npz", ".bin"):
            p = directory / f"{stem}{suffix}"
            if p.exists():
                return p
        raise FileNotFoundError(f"no feature file for {stem} in {directory}")

    def _load_visual_impl(self, fname: str) -> np.ndarray:
        return _load_feature_file(self._find(self.video_feature_dir, fname))

    def _load_asr_impl(self, video_id: str) -> tuple:
        feats = _load_feature_file(self._find(self.asr_feature_dir, video_id))
        subs = load_srt(str(self.asr_dir / f"{video_id}.srt"))
        bounds = tuple((s.start_seconds, s.end_seconds) for s in subs)
        return feats, bounds

    # -- public API ------------------------------------------------------

    def visual(self, fname: str, n_model_frames: int = -1) -> np.ndarray:
        """[T, 1024] features, resampled to n_model_frames when > 0."""
        feats = self._load_visual(fname)
        if n_model_frames > 0 and feats.shape[0] != n_model_frames:
            feats = resample_frames(feats, n_model_frames)
        return feats

    def asr(self, fname: str, n_video_frames: int, n_model_frames: int = -1) -> np.ndarray:
        """Per-second warped ASR embeddings aligned to the visual timeline;
        `n_video_frames` is the raw (1 fps) visual length before resampling
        (hirest_dataset.py:359-405)."""
        video_id = fname.replace(".mp4", "")
        feats, bounds = self._load_asr(video_id)
        warped = native.warp_segments(feats, list(bounds), n_video_frames)
        if n_model_frames > 0 and warped.shape[0] != n_model_frames:
            warped = resample_frames(warped, n_model_frames)
        return warped
