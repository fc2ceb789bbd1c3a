"""Video download frontend (reference extraction/video_features/download_videos.py:
pytube best-progressive-mp4 per id, errors swallowed per video).

A copy of hirest_tpu/extraction/download.py, with its CLI (`python -m
hirest_tpu_torch.extraction.download --data_folder data/splits/
--save_path data/videos/`). pytube is not a dependency of the repository;
without it this raises with a clear error. The data pipeline only needs
the .mp4 files — bring them by any means.
"""

from __future__ import annotations

from pathlib import Path


def download_videos(video_ids, out_dir: str) -> int:
    try:
        from pytube import YouTube
    except ImportError as e:
        raise ImportError(
            "pytube is not installed; download the videos on a "
            "networked host (any tool producing {id}.mp4 files works)") from e

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for vid in video_ids:
        target = out_dir / f"{vid}.mp4"
        if target.exists():
            n += 1
            continue
        try:
            yt = YouTube(f"https://www.youtube.com/watch?v={vid}")
            stream = (yt.streams.filter(progressive=True, file_extension="mp4")
                      .order_by("resolution").desc().first())
            stream.download(output_path=str(out_dir), filename=f"{vid}.mp4")
            n += 1
        except Exception as e:  # per-video failures are logged, not fatal
            print(f"download failed for {vid}: {e}")
    return n


def _ids_from_splits(data_folder: str) -> list:
    """Collect video ids from the split JSONs (reference
    download_videos.py reads all_data_*.json and downloads every video)."""
    import json

    ids = []
    seen = set()
    for split_file in sorted(Path(data_folder).glob("all_data_*.json")):
        with open(split_file) as f:
            anns = json.load(f)
        for vids in anns.values():
            for fname in vids:
                vid = fname[:-4] if fname.endswith(".mp4") else fname
                if vid not in seen:
                    seen.add(vid)
                    ids.append(vid)
    return ids


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(
        description="Download HiREST videos (reference "
                    "extraction/video_features/download_videos.py parity)")
    p.add_argument("--data_folder", type=str, default="./data/splits/")
    p.add_argument("--save_path", type=str, default="./data/videos/")
    a = p.parse_args()
    ids = _ids_from_splits(a.data_folder)
    print(f"{len(ids)} videos listed in {a.data_folder}")
    n = download_videos(ids, a.save_path)
    print(f"{n} videos present in {a.save_path}")
