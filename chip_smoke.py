#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hirest_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py      # needs one CUDA GPU and nvcc

Phases; any failure exits non-zero before the result line is printed:

1. build    compile every CUDA kernel of the port from this checkout (set-up).
2. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, at the main path's shapes (EVA-g attention qkv
            [B, 257, 4224] bf16, B = 2 and 128).
3. main     the extraction encoder at full EVA-g width (40 layers, 1408 wide,
            seeded random weights): make_eva_encoder(device="cuda") for the
            float and the uint8 front end, a few synthetic videos through the
            per-video finish of extract_video_features. Every launch count is
            zeroed before and read after; each kernel must have launched
            (the attention kernel exactly 40 times per forward).
4. depth    the same weights cut to 2 layers: bf16 on the card against the
            plain path on the CPU in f32, cosine >= 0.99.
5. timing   frames/s at B=128, and each kernel's ms per call beside its plain
            version, one library call computing the same function, and the
            card's bound.
6. profile  where one forward's device time goes, by group of kernels, the
            device's idle share, and each plain per-layer op timed alone.

Then it prints the card's name and power limit, one JSON line of kernels and,
last, {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 128  # frames per forward on the main path
# synthetic videos: frame count and duration in seconds (truncation target)
VIDEOS = {"vid_a": (200, 199.6), "vid_b": (90, 88.4), "vid_c": (17, 17.0)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
COS_MIN = 0.99


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def gpu_name_and_power() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def normalize_frames(u8: np.ndarray) -> np.ndarray:
    """What preprocess_image makes of a 224x224 frame (no resize needed)."""
    from hirest_tpu_torch.models.eva_clip import CLIP_MEAN, CLIP_STD

    return ((u8.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD


def attention_inputs(batch: int, seed: int) -> torch.Tensor:
    # std 0.75: what the trunk's qkv projection gives with 0.02 weights
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((batch, 257, 3 * 1408), generator=g, device="cuda")
            * 0.75).to(torch.bfloat16)


def phase_kernels(cfg) -> dict:
    """K1 against its plain version at B = 2 and B = 128."""
    from hirest_tpu_torch.ops.attention import (fused_attention_qkv3,
                                                fused_attention_qkv3_ref)

    scale = cfg.head_width ** -0.5
    worst = 0.0
    for batch in (2, BATCH):
        qkv = attention_inputs(batch, seed=batch)
        got = fused_attention_qkv3(qkv, scale, cfg.num_heads)
        torch.cuda.synchronize()
        want = fused_attention_qkv3_ref(qkv, scale, cfg.num_heads)
        err = (got.float() - want.float()).abs().max().item()
        # 2^-7 of the output's largest magnitude, one to two bf16 ulps
        # there: p may round the other way at a bf16 boundary under another
        # summation order, and the output rounds once to bf16
        tol = 2 ** -7 * want.float().abs().max().item()
        rel = err / want.float().abs().max().item()
        print(f"[kernels] fused_attention_qkv3 B={batch}: max_abs_err={err} "
              f"max_err/max|ref|={rel} tol={tol}")
        require(bool(got.isfinite().all()) and err <= tol,
                f"fused_attention_qkv3 B={batch} off its plain version")
        worst = max(worst, err)
    return {"max_abs_err": worst}


def phase_main(cfg, pretrained: Path) -> dict:
    """The extraction encoder on a few videos, float and uint8 front ends."""
    from hirest_tpu_torch.extraction.features import (finish_video_features,
                                                      make_eva_encoder)
    from hirest_tpu_torch.ops.attention import fused_attention_qkv3

    t0 = time.perf_counter()
    encoders = {u8: make_eva_encoder(str(pretrained), uint8_frontend=u8,
                                     device="cuda")[0]
                for u8 in (False, True)}
    print(f"[main] two full-width encoders staged in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    frames = {v: rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
              for v, (n, _) in VIDEOS.items()}

    fused_attention_qkv3.launches = 0
    forwards = 0
    feats = {}
    t0 = time.perf_counter()
    for u8, enc in encoders.items():
        for vid, (n, duration) in VIDEOS.items():
            embs = []
            for i in range(0, n, BATCH):
                chunk = frames[vid][i: i + BATCH]
                k = len(chunk)
                batch = np.zeros((BATCH, 224, 224, 3), np.uint8)
                batch[:k] = chunk
                embs.append(enc(batch if u8 else normalize_frames(batch))[:k])
                forwards += 1
            feats[u8, vid] = finish_video_features(embs, duration=duration)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_attention_qkv3.launches
    print(f"[main] {forwards} forwards of {BATCH} frames in {seconds:.2f} s; "
          f"fused_attention_qkv3 launches={launches}")
    require(launches == cfg.layers * forwards,
            f"attention launches {launches} != {cfg.layers} x {forwards}")

    for vid, (n, duration) in VIDEOS.items():
        f, fu = feats[False, vid], feats[True, vid]
        want = (round(duration), cfg.embed_dim)
        require(f.shape == want and fu.shape == want,
                f"{vid}: shape {f.shape}/{fu.shape}, expected {want}")
        require(bool(np.isfinite(f).all() and np.isfinite(fu).all()),
                f"{vid}: non-finite features")
        require(bool(np.allclose(np.linalg.norm(f, axis=-1), 1, atol=1e-3)),
                f"{vid}: features not L2-normalized")
        cos = cosine(f, fu).min()
        print(f"[main] {vid}: {f.shape} finite, unit norm; "
              f"min cosine float vs uint8 front end = {cos:.6f}")
        require(cos >= COS_MIN, f"{vid}: uint8 front end off the float one")
    return {"launches": launches, "encoders": encoders, "frames": frames}


def phase_depth(cfg, pretrained: Path) -> None:
    """The same weights at 2 layers: card bf16 vs CPU f32 plain path."""
    from dataclasses import replace

    from hirest_tpu_torch.models.convert import load_torch_ckpt
    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    cut = replace(cfg, layers=2)
    ckpt = pretrained / "eva_clip_psz14.pt"
    # random init draws blocks in order, so 2 layers are the first 2 of 40
    sd = (load_torch_ckpt(str(ckpt)) if ckpt.exists()
          else random_eva_vision_state_dict(cut, seed=0))
    frames = normalize_frames(np.random.default_rng(1).integers(
        0, 256, (4, 224, 224, 3), dtype=np.uint8))
    gpu = build_scanned_vision_apply(sd, cut, device="cuda")(frames)
    cpu = build_scanned_vision_apply(sd, cut, dtype=torch.float32,
                                     device="cpu")(frames)
    cos = cosine(gpu.cpu().numpy(), cpu.numpy())
    print(f"[depth] 2 layers, bf16 card vs f32 CPU plain: cosine "
          f"min={cos.min():.6f} (>= {COS_MIN})")
    require(gpu.shape == (4, cfg.embed_dim) and bool(cos.min() >= COS_MIN),
            "2-layer bf16 forward off the f32 plain path")


def phase_timing(cfg, main: dict, card: str) -> dict:
    from hirest_tpu_torch.ops.attention import (fused_attention_qkv3,
                                                fused_attention_qkv3_ref)

    out = {}
    for u8, enc in main["encoders"].items():
        u8_frames = main["frames"]["vid_a"][:BATCH]
        batch = u8_frames if u8 else normalize_frames(u8_frames)
        enc(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            enc(batch)
        torch.cuda.synchronize()
        fps = BATCH * iters / (time.perf_counter() - t0)
        name = "uint8" if u8 else "float"
        print(f"[timing] {card}: encoder ({name} front end, host frames "
              f"in) B={BATCH}: {fps:.2f} frames/s")
        out[f"fps_{name}"] = fps

    scale, heads, d = cfg.head_width ** -0.5, cfg.num_heads, cfg.head_width
    qkv = attention_inputs(BATCH, seed=7)
    b, s, three_hd = qkv.shape
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    ms = cuda_ms(lambda: fused_attention_qkv3(qkv, scale, heads), 20)
    plain_ms = cuda_ms(lambda: fused_attention_qkv3_ref(qkv, scale, heads), 5)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=scale), 20)
    moved = qkv.numel() * 2 + b * s * (three_hd // 3) * 2
    flops = 2 * 2 * b * heads * s * s * d  # QK^T and PV
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    print(f"[timing] {card}: fused_attention_qkv3 B={BATCH}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
          f"ops {ops_ms:.4f})")
    out["attention"] = {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    return out


KERNEL_GROUPS = (  # (group, substrings of a device kernel's name)
    ("K1 attention_qkv3 (CUDA)", ("attention_qkv3",)),
    ("projections (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("layer_norm", ("layer_norm",)),
    ("elementwise (GELU chain, casts, bias, residual)",
     ("elementwise", "reduce")),
)


def phase_profile(cfg, main: dict, card: str) -> None:
    """Where one float-path forward's time goes: device kernels by group
    from torch.profiler, the device's idle share of the forward's wall
    time, and each plain per-layer op timed alone at the main path's
    shapes with CUDA events."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hirest_tpu_torch.models.eva_clip import layer_norm
    from hirest_tpu_torch.models.layers import gelu_bf16_poly

    enc = main["encoders"][False]
    batch = normalize_frames(main["frames"]["vid_a"][:BATCH])
    enc(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in e.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    busy = sum(groups.values())
    print(f"[profile] {card}: one forward B={BATCH}: wall {wall_ms:.2f} ms "
          f"(profiled), device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.4f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {g}: {ms:.2f} ms ({ms / busy:.4f} of busy)")

    m, w, hid = BATCH * 257, cfg.width, cfg.mlp_hidden
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02
                ).to(torch.bfloat16)

    x, h = rnd(m, w) * 50, rnd(m, hid) * 50
    wq, bq, wp, bp = rnd(3 * w, w), rnd(3 * w), rnd(w, w), rnd(w)
    w1, b1, w2, b2 = rnd(hid, w), rnd(hid), rnd(w, hid), rnd(w)
    norm = torch.nn.LayerNorm(w, device="cuda")
    ops = {
        "qkv linear [M,1408]x[1408,4224]": lambda: F.linear(x, wq, bq),
        "proj linear [M,1408]x[1408,1408]": lambda: F.linear(x, wp, bp),
        "fc1 linear [M,1408]x[1408,6144]": lambda: F.linear(x, w1, b1),
        "fc2 linear [M,6144]x[6144,1408]": lambda: F.linear(h, w2, b2),
        "gelu_bf16_poly [M,6144]": lambda: gelu_bf16_poly(h),
        "layer_norm (f32) [M,1408]": lambda: layer_norm(x, norm),
    }
    for name, fn in ops.items():
        print(f"[profile] {card}: {name}, M={m}: "
              f"{cuda_ms(fn, 10):.4f} ms per call")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 1
    from hirest_tpu_torch.config import EvaVisionConfig
    from hirest_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    cfg = EvaVisionConfig()
    pretrained = REPO / "pretrained_weights"

    t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {len(logs)} CUDA sources compiled in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"[build] {name}:\n{log.strip()}")

    kern = phase_kernels(cfg)
    main_res = phase_main(cfg, pretrained)
    phase_depth(cfg, pretrained)
    timing = phase_timing(cfg, main_res, card)
    phase_profile(cfg, main_res, card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "fused_attention_qkv3", "route": "cuda",
        "source": "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
        "replaces": "hirest_tpu/ops/attention.py:471",
        "launches": main_res["launches"],
        "max_abs_err": kern["max_abs_err"], **timing["attention"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
