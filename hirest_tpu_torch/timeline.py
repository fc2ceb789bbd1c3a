"""Timeline binning and resampling library.

An own copy of hirest_tpu/timeline.py (the port imports nothing of the JAX
package). It converts between wall-clock timestamps (seconds) and model
frame indices, and resamples frame-aligned feature sequences. The
reference implementation spreads four copies of this logic across its
codebase (reference hirest_dataset.py:12-68, 333-354, 383-404 and
modeling.py:529-554); here it is one pure NumPy module.

All functions are pure and host-side (NumPy): the results feed the
padded batches that the model runs on the device.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "timeline_bins",
    "timestamp_to_frame_index",
    "frame_index_to_timestamp",
    "subsample_indices",
    "repeat_upsample_counts",
    "resample_frames",
    "warp_segments",
    "trim_to_moment",
]


def timeline_bins(video_duration: float, n_frames: int = -1) -> np.ndarray:
    """Bin edges dividing a video of `video_duration` seconds into `n_frames` bins.

    Mirrors reference hirest_dataset.py:12-40: the duration is truncated to an
    int, and `n_frames < 0` means one bin per second of (truncated) duration.
    """
    video_duration = int(video_duration)
    if n_frames < 0:
        n_frames = video_duration
    return np.linspace(0, video_duration - 1, n_frames)


def timestamp_to_frame_index(timestamp: float, video_duration: float, n_frames: int = -1) -> int:
    """Convert a timestamp in seconds to a frame (bin) index.

    Parity with reference hirest_dataset.py:12-40, including the
    `np.digitize(..., right=True)` boundary convention and the clamp to
    `n_frames - 1`.
    """
    bins = timeline_bins(video_duration, n_frames)
    if bins.size == 0:
        # degenerate: duration truncates to 0 seconds — there is NO valid
        # bin; min(digitize, n-1) would silently return -1, which indexes
        # the last element of downstream arrays or corrupts class targets
        raise ValueError(
            f"video_duration={video_duration!r} yields zero timeline bins "
            f"(n_frames={n_frames}); skip videos shorter than 1 second")
    bin_index = np.digitize(timestamp, bins, right=True)
    return int(min(bin_index, bins.size - 1))


def frame_index_to_timestamp(frame_index: int, video_duration: float, n_frames: int = -1) -> int:
    """Convert a frame (bin) index back to a timestamp in (truncated) seconds.

    Parity with reference hirest_dataset.py:42-68, including the final
    `int()` truncation of the bin edge.
    """
    return int(timeline_bins(video_duration, n_frames)[frame_index])


def subsample_indices(n_source: int, n_target: int) -> np.ndarray:
    """Uniform linspace subsample indices (used when n_source > n_target).

    Parity with reference hirest_dataset.py:336-340.
    """
    return np.linspace(0, n_source - 1, n_target).astype(int)


def repeat_upsample_counts(n_source: int, n_target: int) -> np.ndarray:
    """Per-source repeat counts for deterministic upsampling to `n_target` rows.

    The reference implements this with a nested-list slicing trick
    (hirest_dataset.py:342-354); the closed form is: source row ``k``
    fills output slots ``[k*n_target//n_source, (k+1)*n_target//n_source)``.
    Returns an int array of length `n_source` summing to `n_target`.
    """
    k = np.arange(n_source + 1)
    edges = (k * n_target) // n_source
    return np.diff(edges)


def resample_frames(features: np.ndarray, n_target: int) -> np.ndarray:
    """Resample a [T, D] feature sequence to exactly [n_target, D].

    Subsamples via linspace when T > n_target, repeat-upsamples when
    T <= n_target — exactly the reference's two branches
    (hirest_dataset.py:333-354). Works on any array with time as axis 0.
    """
    n_source = features.shape[0]
    if n_source == 0:
        # numpy's integer //0 would silently yield an EMPTY result (with
        # only a RuntimeWarning); zeros of the requested shape keep batch
        # stacking well-formed, matching the reference's zeros behavior
        return np.zeros((n_target,) + features.shape[1:], features.dtype)
    if n_source > n_target:
        return features[subsample_indices(n_source, n_target)]
    counts = repeat_upsample_counts(n_source, n_target)
    return np.repeat(features, counts, axis=0)


def warp_segments(
    segment_features: np.ndarray,
    segment_bounds_sec: list[tuple[int, int]],
    n_video_frames: int,
) -> np.ndarray:
    """Warp per-segment vectors onto a 1-frame-per-second timeline.

    Each segment's vector is written into its [start, end) seconds; later
    segments overwrite earlier ones on overlap; uncovered seconds stay zero.
    Parity with the reference's ASR warping (hirest_dataset.py:371-381),
    where start/end come from `timedelta.seconds` (already ints).
    """
    dim = segment_features.shape[1]
    warped = np.zeros((n_video_frames, dim), dtype=np.float32)
    for i, (start, end) in enumerate(segment_bounds_sec):
        start = max(0, int(start))
        end = min(n_video_frames, int(end))
        if end > start:
            warped[start:end] = segment_features[i]
    return warped


def trim_to_moment(features: np.ndarray, moment_mask: np.ndarray, n_target: int) -> np.ndarray:
    """Select moment frames and resize the selection to exactly `n_target` rows.

    Truncates when the moment is longer than `n_target`, repeat-upsamples
    otherwise — parity with reference modeling.py:529-554 (`trim_feats`).
    """
    z = features[moment_mask.astype(bool)]
    n = z.shape[0]
    if n == 0:
        # all-zero mask: (n_target, D) zeros, matching the reference
        # trim_feats and the native featpack kernel (not a (0, D) array
        # that breaks downstream np.stack)
        return np.zeros((n_target,) + features.shape[1:], features.dtype)
    if n_target < n:
        return z[:n_target]
    counts = repeat_upsample_counts(n, n_target)
    return np.repeat(z, counts, axis=0)
