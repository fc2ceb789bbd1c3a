"""Zero-shot video retrieval.

Counterpart of hirest_tpu/infer/retrieval.py, with parity to the reference
inference_video_retrieval.py: encode prompts with the CLIP text tower,
encode videos either from precomputed features (linspace-resample to
n_model_frames -> mean-pool -> L2 normalize, lines 298-327) or from raw
frames (encode_image over n_model_frames frames, lines 220-288), then score
`text @ video.T` and dump one JSON of per-prompt candidate scores.

The towers run where their encode functions put them (the port's run on
the card); the embeddings come back to the host as float32 numpy, where
the JAX package keeps them too.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from hirest_tpu_torch.timeline import subsample_indices


def _host(x) -> np.ndarray:
    """An encode function's output (a tensor on any device, or an array)
    as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def load_retrieval_split(data_dir: str, split: str):
    """(prompts, video_fnames) with the reference's per-(prompt, video)
    enumeration order (inference_video_retrieval.py:87-106)."""
    with open(os.path.join(data_dir, f"all_data_{split}.json")) as f:
        data = json.load(f)
    prompts, videos = [], []
    for prompt in data:
        prompts.append(prompt)
        for video in data[prompt]:
            videos.append(video)
    return prompts, videos


def encode_texts(encode_text_fn: Callable, prompts: Sequence[str],
                 batch_size: int = 32) -> np.ndarray:
    """Batch-encode prompts -> L2-normalized [P, D]."""
    from hirest_tpu_torch.tokenizers import clip_tokenize

    out = []
    for i in range(0, len(prompts), batch_size):
        ids = clip_tokenize(list(prompts[i: i + batch_size]))
        out.append(_host(encode_text_fn(ids)))
    embs = np.concatenate(out, axis=0)
    return embs / np.linalg.norm(embs, axis=-1, keepdims=True)


def encode_videos_from_features(feature_dir: str, video_ids: Sequence[str],
                                n_model_frames: int) -> np.ndarray:
    """Mean-pooled normalized embeddings [V, D] from precomputed features.

    As the reference, linspace indexing applies whenever n_model_frames > 0,
    repeat-style upsampling of short videos included
    (inference_video_retrieval.py:310-317).
    """
    from hirest_tpu_torch.data.features import _load_feature_file

    out = []
    feature_dir = Path(feature_dir)
    for vid in video_ids:
        path = None
        for suffix in (".pt", ".npy", ".npz"):
            cand = feature_dir / f"{vid}{suffix}"
            if cand.exists():
                path = cand
                break
        if path is None:
            raise FileNotFoundError(f"no features for {vid} in {feature_dir}")
        feats = _load_feature_file(path)
        if n_model_frames > 0:
            feats = feats[subsample_indices(feats.shape[0], n_model_frames)]
        emb = feats.astype(np.float32).mean(axis=0)
        out.append(emb / np.linalg.norm(emb))
    return np.stack(out)


def encode_videos_from_frames(frame_dir: str, video_ids: Sequence[str],
                              encode_image_fn: Callable, preprocess_fn: Callable,
                              n_model_frames: int, batch_size: int = 8,
                              save_feature_dir: Optional[str] = None) -> np.ndarray:
    """Raw-frame path: per video, encode n_model_frames linspace-sampled
    frames and mean-pool. `encode_image_fn` maps [N,H,W,3] -> [N,D] (the
    port's `encode_image`); the frame decode runs a video ahead of it on a
    prefetch thread."""
    from PIL import Image

    from hirest_tpu_torch.data.prefetch import prefetch
    from hirest_tpu_torch.extraction.frames import resolve_frame_dir

    def _decoded():
        for vid in video_ids:
            vdir = resolve_frame_dir(frame_dir, vid)
            frame_paths = sorted(vdir.glob("frame_*.jpg"))
            if not frame_paths:
                raise FileNotFoundError(f"no frames for {vid} in {vdir}")
            ids = subsample_indices(len(frame_paths), n_model_frames)
            yield vid, np.stack([
                preprocess_fn(Image.open(frame_paths[i]).convert("RGB"))
                for i in ids])

    out = []
    if save_feature_dir:
        os.makedirs(save_feature_dir, exist_ok=True)
    for vid, imgs in prefetch(_decoded()):
        embs = np.concatenate([
            _host(encode_image_fn(imgs[i: i + batch_size]))
            for i in range(0, len(imgs), batch_size)], axis=0)
        if save_feature_dir:
            np.save(Path(save_feature_dir) / f"{vid}.npy", embs)
        emb = embs.mean(axis=0)
        out.append(emb / np.linalg.norm(emb))
    return np.stack(out)


def score_and_dump(prompts: Sequence[str], video_ids: Sequence[str],
                   text_embeds: np.ndarray, video_embeds: np.ndarray,
                   run_name: str, save_dir: str = "VR_results") -> dict:
    """text @ video.T, emitted in the reference's JSON schema
    (inference_video_retrieval.py:333-355)."""
    scores = text_embeds @ video_embeds.T
    results = {}
    for i, prompt in enumerate(prompts):
        results[prompt] = {"videos": list(video_ids),
                           "scores": scores[i].tolist()}
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{run_name}.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=4)
    print(f"Saved results to {path}")
    return results


def run_video_retrieval(config, encode_text_fn, encode_image_fn=None,
                        preprocess_fn=None) -> dict:
    """The whole retrieval flow (the reference __main__, lines 150-355):
    the test split's prompts against its videos and the negative samples',
    from features, or with `config.raw_frame` from the extracted frames
    under `config.video_dir`; writes VR_results/{run_name}.json."""
    prompts, test_videos = load_retrieval_split(config.data_dir, "test")
    _, distractors = load_retrieval_split(config.data_dir,
                                          "test_negative_samples")
    all_videos = test_videos + distractors
    print(f"Number of prompts: {len(prompts)}")
    print(f"Number of videos: {len(all_videos)}")

    text_embeds = encode_texts(encode_text_fn, prompts,
                               config.eval_batch_size)

    if config.raw_frame:
        # the extracted-frames root is its own flag (reference
        # inference_video_retrieval.py:221 uses args.video_dir): neither the
        # splits dir nor the feature dir
        if not config.video_dir:
            raise ValueError(
                "--raw_frame needs --video_dir: the root of per-video "
                "extracted frame directories (see extraction/frames.py)")
        video_embeds = encode_videos_from_frames(
            config.video_dir, all_videos, encode_image_fn, preprocess_fn,
            config.n_model_frames, batch_size=config.eval_batch_size,
            save_feature_dir=(config.video_feature_dir if config.save_feats
                              else None))
    else:
        video_embeds = encode_videos_from_features(
            config.video_feature_dir, all_videos, config.n_model_frames)

    return score_and_dump(prompts, all_videos, text_embeds, video_embeds,
                          config.run_name)
