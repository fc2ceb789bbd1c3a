"""Custom-video end-to-end pipeline.

Counterpart of hirest_tpu/infer/custom_video.py, on the port's modules.
Script equivalent of the reference's custom_video_pipeline.ipynb: given one
video file and a prompt, build a single-video annotation, extract frames ->
EVA features (+ optional audio/ASR when those tools are present), then run
the staged MR -> MS -> SC pipeline and return the hierarchical result.
Runs on `config.device` (CUDA unless "cpu").
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Optional


def probe_duration(video_path: str) -> float:
    """Video duration in seconds via OpenCV."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    try:
        # VideoCapture does not raise on a missing/unreadable file — fail
        # fast instead of proceeding with duration 0.0 (bounds [0, 0]) and
        # returning a 'successful' but meaningless pipeline result
        if not cap.isOpened():
            raise FileNotFoundError(
                f"cannot open video: {video_path!r} (missing file or "
                f"unsupported codec)")
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frames = cap.get(cv2.CAP_PROP_FRAME_COUNT)
        duration = float(frames / fps) if fps > 0 else 0.0
        if duration <= 0:
            raise ValueError(f"video {video_path!r} reports no frames")
        return duration
    finally:
        cap.release()


def build_single_video_annotation(video_path: str, prompt: str,
                                  duration: Optional[float] = None) -> dict:
    """One-video annotation dict in the all_data_*.json schema with the full
    video as the moment and 5 placeholder steps (the notebook's cell that
    seeds the end-to-end chain)."""
    duration = duration if duration is not None else probe_duration(video_path)
    fname = Path(video_path).name
    return {prompt: {fname: {
        "relevant": True,
        "clip": True,
        "v_duration": duration,
        "bounds": [0, int(duration)],
        "steps": [{"index": i, "heading": "", "absolute_bounds": [i, i + 1]}
                  for i in range(5)],
    }}}


def run_custom_video(
    video_path: str,
    prompt: str,
    config,
    encode_image_fn=None,
    preprocess_fn=None,
    text_encoder_fn=None,
    wordpiece_tokenizer=None,
    work_dir: Optional[str] = None,
    extract_asr: bool = False,
    trainer=None,
) -> dict:
    """Full flow: frames -> features (-> audio/ASR) -> staged pipeline.

    Model functions are injectable (tests use fakes); by default the EVA
    tower is built from config.pretrained_dir on config.device: the bf16
    scanned forward with its uint8 front end (K1, 40 launches a forward).
    ASR, as in the JAX package, goes through `transcribe_audio_dir`, which
    needs the openai-whisper package."""
    from hirest_tpu_torch.extraction.features import (extract_video_features,
                                                      make_eva_encoder)
    from hirest_tpu_torch.extraction.frames import extract_frames
    from hirest_tpu_torch.infer.pipeline import run_end_to_end
    from hirest_tpu_torch.train.trainer import Trainer

    work_dir = Path(work_dir or tempfile.mkdtemp(prefix="hirest_custom_"))
    video_path = Path(video_path)
    fname = video_path.name
    video_id = video_path.stem

    # 1) annotation
    anns = build_single_video_annotation(str(video_path), prompt)
    splits = work_dir / "splits"
    splits.mkdir(parents=True, exist_ok=True)
    test_json = splits / "all_data_test.json"
    with open(test_json, "w") as f:
        json.dump(anns, f)

    # 2) frames
    frame_dir = work_dir / "frames"
    extract_frames(str(video_path.parent), str(frame_dir), num_workers=1,
                   video_ids=[video_id])

    # 3) visual features
    feat_dir = work_dir / "feats"
    if encode_image_fn is None:
        # raw-uint8 frontend: normalization folded into the patch embed,
        # 4x less host->device traffic for the streamed custom-video frames
        encode_image_fn, preprocess_fn = make_eva_encoder(
            config.pretrained_dir, uint8_frontend=True, device=config.device)
    duration = anns[prompt][fname]["v_duration"]
    extract_video_features(str(frame_dir), str(feat_dir), encode_image_fn,
                           preprocess_fn, video_ids=[video_id],
                           durations={video_id: duration})
    # the data layer looks features up by fname (with .mp4)
    src = feat_dir / f"{video_id}.npy"
    if src.exists() and not (feat_dir / f"{fname}.npy").exists():
        os.rename(src, feat_dir / f"{fname}.npy")

    # 4) optional audio/ASR
    asr_dir = asr_feat_dir = None
    if extract_asr:
        from hirest_tpu_torch.extraction.asr import (embed_srt_dir,
                                                     transcribe_audio_dir)
        from hirest_tpu_torch.extraction.audio import extract_audio

        audio_dir = work_dir / "audio"
        extract_audio(str(video_path.parent), str(audio_dir), num_workers=1)
        asr_dir = work_dir / "ASR"
        transcribe_audio_dir(str(audio_dir), str(asr_dir))
        asr_feat_dir = work_dir / "ASR_feats_all-MiniLM-L6-v2"
        embed_srt_dir(str(asr_dir), str(asr_feat_dir), device=config.device)

    # 5) staged pipeline
    if trainer is None:
        import dataclasses

        config = dataclasses.replace(
            config, data_dir=str(splits), video_feature_dir=str(feat_dir),
            asr_dir=str(asr_dir) if asr_dir else None,
            asr_feature_dir=str(asr_feat_dir) if asr_feat_dir else None,
            end_to_end=True,
            ckpt_dir=config.ckpt_dir or str(work_dir / "out"))
        trainer = Trainer(config, text_encoder_fn=text_encoder_fn,
                          wordpiece_tokenizer=wordpiece_tokenizer)
        if config.load:
            if str(config.load).endswith(".pth"):
                trainer.load_torch_checkpoint(config.load)
            else:
                trainer.load(config.load)
    return run_end_to_end(trainer, str(test_json))
