"""Frame extraction: videos -> 1 frame/sec JPEG sequences.

An own copy of hirest_tpu/extraction/frames.py (the port imports nothing
of the JAX package). Parity with reference
extraction/video_features/extract_frames.py: OpenCV seek-by-millisecond at
RATE=1 fps (`frame_index * 1000` ms), frames named `frame_%06d.jpg`, fanned
out over a process pool, idempotent (existing outputs skipped).

    python -m hirest_tpu_torch.extraction.frames --video_dir VIDEOS \
        --frame_dir FRAMES [--num_workers 8]
"""

from __future__ import annotations

import multiprocessing as mp
from pathlib import Path

RATE = 1  # frames per second


def extract_frames_for_video(args) -> int:
    video_path, out_dir = args
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        print(f"could not open {video_path}")
        return 0
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    n_total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    duration = n_total / fps if fps > 0 else 0
    count = 0
    for sec in range(int(duration * RATE)):
        out_path = out_dir / f"frame_{str(sec).zfill(6)}.jpg"
        if out_path.exists():
            count += 1
            continue
        cap.set(cv2.CAP_PROP_POS_MSEC, sec * 1000 / RATE)
        ok, frame = cap.read()
        if not ok:
            break
        cv2.imwrite(str(out_path), frame)
        count += 1
    cap.release()
    return count


def resolve_frame_dir(root, video_id) -> Path:
    """Per-video frame directories exist under two naming conventions: this
    extractor writes <root>/<stem>/ (extract_frames below), while the
    reference extractor keys directories by the FULL filename
    (<root>/<vid>.mp4/, extract_frames.py:15-36). Accept either. Returns
    the first candidate when none exists, so the caller's error message
    names the primary path."""
    root = Path(root)
    cands = (root / str(video_id),
             root / Path(str(video_id)).stem,
             root / f"{video_id}.mp4")
    for c in cands:
        if c.is_dir():
            return c
    return cands[0]


def extract_frames(video_dir: str, frame_dir: str, num_workers: int = 8,
                   video_ids=None) -> int:
    """Extract frames for every .mp4 in video_dir into frame_dir/{id}/."""
    video_dir = Path(video_dir)
    frame_dir = Path(frame_dir)
    videos = sorted(video_dir.glob("*.mp4"))
    if video_ids is not None:
        wanted = set(video_ids)
        videos = [v for v in videos if v.stem in wanted or v.name in wanted]
    jobs = [(str(v), str(frame_dir / v.stem)) for v in videos]
    if num_workers <= 1:
        return sum(extract_frames_for_video(j) for j in jobs)
    # spawn, not fork: the caller may hold CUDA and threads
    with mp.get_context("spawn").Pool(num_workers) as pool:
        return sum(pool.map(extract_frames_for_video, jobs))


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--video_dir", required=True)
    p.add_argument("--frame_dir", required=True)
    p.add_argument("--num_workers", type=int, default=8)
    a = p.parse_args()
    n = extract_frames(a.video_dir, a.frame_dir, a.num_workers)
    print(f"extracted {n} frames")
