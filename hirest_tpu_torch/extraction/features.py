"""EVA-CLIP visual feature extraction: frame JPEGs -> per-video features.

Counterpart of hirest_tpu/extraction/features.py, with the same output
contract (reference extraction/video_features/extract_features.py and
check_feature_size.py): sorted frames, batch-chunked encode, L2-normalized,
truncated to the rounded duration, one {video_id}.npy [n_frames, 1024] per
video, videos already done skipped.

    python -m hirest_tpu_torch.extraction.features --frame_dir FRAMES \
        --out_dir FEATS [--int8] [--uint8_frontend] [--device cpu] \
        [--trace_dir TRACES]

It runs on CUDA unless --device cpu is given. With --trace_dir the run is
traced by torch.profiler, as the trainer's --trace_dir does, into a Chrome
trace in that directory that holds the extraction's `hirest.*` spans
beside the device's kernels (all but `prefetch.produce`, whose thread the
profiler does not record).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.utils.profiling import span, trace


def _decode_frame(args):
    """(preprocess_fn, path) -> preprocessed array; module-level so it
    pickles into spawn-context decode workers."""
    from PIL import Image

    preprocess_fn, path = args
    return preprocess_fn(Image.open(path).convert("RGB"))


def iter_video_frame_batches(frame_dir: Path, preprocess_fn: Callable,
                             batch_size: int, pool=None):
    """Yields (frame_batch [n,H,W,3], count) over the sorted frames of one
    video directory, final batch zero-padded to batch_size.

    pool: optional executor (see extract_video_features decode_workers) that
    fans the JPEG decode + resize across processes — PIL holds the GIL, so
    threads don't parallelize it."""
    paths = sorted(frame_dir.glob("frame_*.jpg"))
    for i in range(0, len(paths), batch_size):
        chunk = paths[i: i + batch_size]
        work = [(preprocess_fn, p) for p in chunk]
        if pool is not None:
            imgs = np.stack(list(pool.map(_decode_frame, work, chunksize=8)))
        else:
            imgs = np.stack([_decode_frame(w) for w in work])
        n = len(chunk)
        if n < batch_size:
            imgs = np.concatenate(
                [imgs, np.zeros((batch_size - n,) + imgs.shape[1:], imgs.dtype)])
        yield imgs, n


def finish_video_features(embs: Sequence, normalize: bool = True,
                          duration: Optional[float] = None) -> np.ndarray:
    """Per-video finish: concatenate the batch embeddings (tensors or
    arrays, already cut to their real frames) as f32, L2-normalize each row,
    truncate to round(duration) when one is given.

    Spans (utils/profiling.py): `features.fetch` for each batch's fetch to
    the host, which waits for the device to finish it, then
    `features.normalise` for the rest."""
    host = []
    for e in embs:
        with span("features.fetch"):
            host.append(torch.as_tensor(e).float().cpu().numpy())
    with span("features.normalise"):
        feats = np.concatenate(host, axis=0)
        if normalize:
            feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        if duration is not None:
            feats = feats[: round(duration)]
    return feats


def extract_video_features(
    frame_root: str,
    out_dir: str,
    encode_image_fn: Callable,
    preprocess_fn: Callable,
    batch_size: int = 64,
    video_ids: Optional[Sequence[str]] = None,
    normalize: bool = True,
    process_id: int = 0,
    num_processes: int = 1,
    durations: Optional[dict] = None,
    decode_workers: int = 0,
) -> int:
    """Encode every video's frames; writes {video_id}.npy [n_frames, 1024].

    `durations` (video_id -> seconds) truncates features to round(duration).
    A background thread keeps 2 decoded batches ahead of the device encode,
    and `decode_workers > 0` fans the per-frame JPEG decode + bicubic resize
    across that many spawn-context processes.

    Under a profiler (utils/profiling.py) each video is a span
    `extract.video` (attr `video`, its id), whose trace the spans of its
    prefetch, forwards and finish share, and its file's write
    `extract.save`."""
    from hirest_tpu_torch.data.prefetch import prefetch

    frame_root, out_dir = Path(frame_root), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if video_ids is None:
        video_ids = sorted(d.name for d in frame_root.iterdir() if d.is_dir())
    video_ids = list(video_ids)[process_id::num_processes]

    pool = None
    if decode_workers > 0:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # spawn, not fork: forking a process with CUDA and threads is unsafe;
        # the workers only ever run PIL
        pool = ProcessPoolExecutor(decode_workers,
                                   mp_context=mp.get_context("spawn"))

    n_done = 0
    try:
        for vid in video_ids:
            out = out_dir / f"{vid}.npy"
            if out.exists():
                continue
            with span("extract.video", video=vid):
                embs = [encode_image_fn(imgs)[:n] for imgs, n in prefetch(
                    iter_video_frame_batches(frame_root / vid, preprocess_fn,
                                             batch_size, pool=pool))]
                if not embs:
                    continue
                duration = durations.get(vid) if durations else None
                feats = finish_video_features(embs, normalize, duration)
                with span("extract.save"):
                    np.save(out, feats)
            n_done += 1
    finally:
        if pool is not None:
            pool.shutdown()
    return n_done


def make_eva_encoder(pretrained_dir: str = "./pretrained_weights",
                     dtype_name: str = "bfloat16", padded_heads: bool = False,
                     scan: bool = True, int8: bool = False,
                     uint8_frontend: bool = False, device=None,
                     cfg: EvaVisionConfig = EvaVisionConfig()):
    """Build (encode_image_fn, preprocess_fn) around the EVA vision tower on
    `device` (CUDA unless "cpu" is asked for), loading
    `{pretrained_dir}/eva_clip_psz14.pt` when present and seeded random
    weights otherwise. encode_image_fn returns [B, embed_dim] f32 on the
    device.

    The default is the production bf16 forward (scan=True):
    build_scanned_vision_apply with attn_v3, the batched-heads attention
    kernel (K1) at the native head width 88, as the JAX encoder builds it.
    `padded_heads=True` pads the heads to 128 (models/eva_pad.py), an
    identity on the outputs that runs the attention at head width 128.
    `scan=False` builds the unrolled tower (the JAX package's flax tower:
    split-heads attention, or packed heads once padded, and exact GELU); it
    ignores `int8` and `uint8_frontend`, as the JAX encoder does, and takes
    normalised float frames.
    `int8=True` is the quantized throughput mode: int8 projections with
    per-channel weight and per-row activation scales, built with
    fused_quant=fused_mlp=True besides attn_v3 (the JAX package's
    production int8 configuration): the ln_quant, int8-epilogue attention
    and fused int8 MLP kernels (K2, K3, K4).
    `uint8_frontend=True` ships raw uint8 frames to the device and runs pixel
    normalization inside the patch-embed matmul."""
    from hirest_tpu_torch.models.eva_clip import (build_unrolled_vision_apply,
                                                  preprocess_image,
                                                  preprocess_image_u8)
    from hirest_tpu_torch.models.eva_pad import pad_vision_head_params
    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
    from hirest_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)  # before building a 1B-parameter tower
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    ckpt = os.path.join(pretrained_dir, "eva_clip_psz14.pt")
    if os.path.exists(ckpt):
        from hirest_tpu_torch.models.convert import load_torch_ckpt

        sd = load_torch_ckpt(ckpt)
        print(f"Loaded EVA-CLIP vision tower from {ckpt}")
    else:
        from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

        sd = random_eva_vision_state_dict(cfg, seed=0)
        print(f"WARNING: {ckpt} not found - vision tower is random-init")
    if padded_heads:
        sd, cfg = pad_vision_head_params(sd, cfg)
    if not scan:
        return (build_unrolled_vision_apply(sd, cfg, dtype=dtype,
                                            device=device), preprocess_image)
    apply = build_scanned_vision_apply(sd, cfg, dtype=dtype, int8=int8,
                                       attn_v3=True, fused_quant=int8,
                                       fused_mlp=int8,
                                       uint8_input=uint8_frontend,
                                       device=device)
    return apply, (preprocess_image_u8 if uint8_frontend else preprocess_image)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--frame_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--pretrained_dir", default="./pretrained_weights")
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--int8", action="store_true",
                   help="quantized throughput mode: int8 projections, "
                        "fused LN/attention/MLP int8 kernels")
    p.add_argument("--uint8_frontend", action="store_true",
                   help="ship raw uint8 frames; normalization folded into "
                        "the patch embed (4x less host->device traffic)")
    p.add_argument("--decode_workers", type=int, default=0,
                   help="JPEG decode/resize worker processes (0 = in-line)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "extraction, with its spans, into this directory")
    a = p.parse_args(argv)
    enc, pre = make_eva_encoder(a.pretrained_dir, int8=a.int8,
                                uint8_frontend=a.uint8_frontend,
                                device=a.device)
    with trace(a.trace_dir):
        n = extract_video_features(a.frame_dir, a.out_dir, enc, pre,
                                   a.batch_size, process_id=a.process_id,
                                   num_processes=a.num_processes,
                                   decode_workers=a.decode_workers)
    print(f"encoded {n} videos")
    return 0


if __name__ == "__main__":
    main()
