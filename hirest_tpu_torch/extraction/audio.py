"""Audio extraction: videos -> 16 kHz mono PCM WAV via ffmpeg.

An own copy of hirest_tpu/extraction/audio.py (the port imports nothing of
the JAX package):

    python -m hirest_tpu_torch.extraction.audio --video_dir VIDEOS \
        --audio_dir WAVS [--num_workers 8]

Parity with reference extraction/whisper_ASR/extract_audio.py (ffmpeg
subprocess, `-ac 1 -ar 16000`, pool fan-out, skip-existing).
"""

from __future__ import annotations

import multiprocessing as mp
import subprocess
from pathlib import Path


def extract_audio_for_video(args) -> bool:
    video_path, wav_path = args
    wav_path = Path(wav_path)
    if wav_path.exists():
        return True
    wav_path.parent.mkdir(parents=True, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", str(video_path), "-vn",
           "-acodec", "pcm_s16le", "-ac", "1", "-ar", "16000", str(wav_path)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"ffmpeg failed for {video_path}: {e}")
        return False


def extract_audio(video_dir: str, audio_dir: str, num_workers: int = 8) -> int:
    video_dir, audio_dir = Path(video_dir), Path(audio_dir)
    jobs = [(str(v), str(audio_dir / f"{v.stem}.wav"))
            for v in sorted(video_dir.glob("*.mp4"))]
    if num_workers <= 1:
        return sum(extract_audio_for_video(j) for j in jobs)
    # spawn, not fork: the caller may hold CUDA and threads
    with mp.get_context("spawn").Pool(num_workers) as pool:
        return sum(pool.map(extract_audio_for_video, jobs))


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--video_dir", required=True)
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--num_workers", type=int, default=8)
    a = p.parse_args()
    print(f"extracted {extract_audio(a.video_dir, a.audio_dir, a.num_workers)} wavs")
