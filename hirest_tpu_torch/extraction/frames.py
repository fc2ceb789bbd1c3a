"""Per-video frame directories.

An own copy of `resolve_frame_dir` from hirest_tpu/extraction/frames.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from pathlib import Path


def resolve_frame_dir(root, video_id) -> Path:
    """Per-video frame directories exist under two naming conventions: the
    JAX package's extractor writes <root>/<stem>/, while the reference
    extractor keys directories by the FULL filename (<root>/<vid>.mp4/,
    extract_frames.py:15-36). Accept either. Returns the first candidate
    when none exists, so the caller's error message names the primary
    path."""
    root = Path(root)
    cands = (root / str(video_id),
             root / Path(str(video_id)).stem,
             root / f"{video_id}.mp4")
    for c in cands:
        if c.is_dir():
            return c
    return cands[0]
