#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hirest_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py      # needs one CUDA GPU and nvcc

Phases; any failure exits non-zero before the result line is printed:

1. build    compile every CUDA kernel of the port from this checkout (set-up).
2. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, at the main paths' shapes: K1 and K3 (attention qkv
            [B, S, 4224] bf16; K3 also padded to S = 264 with n_real = 257),
            K2 (ln_quant, [M, 1408]) and K4 (fused_mlp_int8, [M, 1408] x 6144,
            both activations), B = 2 and 128, M = 257 B.
3. main     the extraction encoder at full EVA-g width (40 layers, 1408 wide,
            seeded random weights): make_eva_encoder(device="cuda"), bf16 and
            int8=True, each with the float and the uint8 front end, a few
            synthetic videos through the per-video finish of
            extract_video_features. Every launch count is zeroed before each
            precision's run and read after it: per forward, the bf16 path
            launches K1 40 times and no int8 kernel; the int8 path launches
            K2 80 times, K3 and K4 40 times each, and no K1.
4. depth    the same weights cut to 2 layers, on the card in bf16 against the
            plain path on the CPU in f32: bf16 vs float at cosine >= 0.99;
            int8 vs int8 at >= 0.99 and int8 vs float at >= 0.98.
5. timing   frames/s at B=128 for both precisions and front ends, and each
            kernel's ms per call beside its plain version, one library call
            computing the same function (or its int8 products, for K4), and
            the card's bound.
6. profile  where one forward's device time goes, by group of kernels, and
            the device's idle share, for each precision; each plain per-layer
            op timed alone.

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
TOKENS = 257  # EVA-g tokens per frame (16 x 16 patches and the class token)
# synthetic videos: frame count and duration in seconds (truncation target)
VIDEOS = {"vid_a": (200, 199.6), "vid_b": (90, 88.4), "vid_c": (17, 17.0)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores
COS_MIN = 0.99
COS_INT8_VS_FLOAT = 0.98  # the JAX package's int8 bar (test_eva_scan.py:57)
EPS = 1e-6


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


def bound(moved_bytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    bytes_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def normalize_frames(u8: np.ndarray) -> np.ndarray:
    """What preprocess_image makes of a 224x224 frame (no resize needed)."""
    from hirest_tpu_torch.models.eva_clip import CLIP_MEAN, CLIP_STD

    return ((u8.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD


def counters() -> dict:
    """Kernel -> (wrapper, attribute) of its launch count."""
    from hirest_tpu_torch.ops.attention import fused_attention_qkv3
    from hirest_tpu_torch.ops.quant import fused_mlp_int8, ln_quant

    return {"K1": (fused_attention_qkv3, "launches"),
            "K2": (ln_quant, "launches"),
            "K3": (fused_attention_qkv3, "quant_launches"),
            "K4": (fused_mlp_int8, "launches")}


def zero_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def attention_inputs(batch: int, seed: int, tokens: int = TOKENS):
    # std 0.75: what the trunk's qkv projection gives with 0.02 weights
    return (torch.randn((batch, tokens, 3 * 1408), generator=gen(seed),
                        device="cuda") * 0.75).to(torch.bfloat16)


def ln_inputs(m: int, seed: int):
    """A residual stream with a per-row spread and offset, LayerNorm params
    near (1, 0)."""
    g = gen(seed)
    x = (torch.randn((m, 1408), generator=g, device="cuda")
         * torch.rand((m, 1), generator=g, device="cuda").mul_(2.5).add_(0.5)
         + torch.randn((m, 1), generator=g, device="cuda")).bfloat16()
    w = 1 + 0.02 * torch.randn(1408, generator=g, device="cuda")
    b = 0.02 * torch.randn(1408, generator=g, device="cuda")
    return x, w, b


def mlp_inputs(m: int, seed: int, hidden: int = 6144):
    """What the trunk hands K4: row-quantized LayerNorm output, weights
    quantized from 0.02-scale floats, a bf16 residual."""
    from hirest_tpu_torch.ops.quant import dyn_quant_rows, quantize_weight

    g = gen(seed)
    h_q, h_s = dyn_quant_rows(torch.randn((m, 1408), generator=g,
                                          device="cuda"))
    w1_q, w1_s = quantize_weight(0.02 * torch.randn(
        (hidden, 1408), generator=g, device="cuda"))
    w2_q, w2_s = quantize_weight(0.02 * torch.randn(
        (1408, hidden), generator=g, device="cuda"))
    b1 = 0.02 * torch.randn(hidden, generator=g, device="cuda")
    b2 = 0.02 * torch.randn(1408, generator=g, device="cuda")
    x = torch.randn((m, 1408), generator=g, device="cuda").bfloat16()
    return h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x


def check_codes(tag: str, got, want, min_equal: float, scale_rel: float):
    """Quantized outputs (codes, scales) against the plain version's: codes
    within one and equal on min_equal of them, scales within scale_rel.
    Returns the largest error of the dequantized values."""
    (q, s), (rq, rs) = got, want
    torch.cuda.synchronize()
    diff = (q.int() - rq.int()).abs()
    equal = (diff == 0).float().mean().item()
    rel = ((s - rs).abs() / rs.abs()).max().item()
    err = (q.float() * s - rq.float() * rs).abs().max().item()
    print(f"[kernels] {tag}: max|dcode|={diff.max().item()} "
          f"equal={equal:.6f} (>= {min_equal}) scale rel={rel:.3e} "
          f"(<= {scale_rel:.3e}) max_abs_err={err}")
    require(bool(s.isfinite().all()) and diff.max().item() <= 1
            and equal >= min_equal and rel <= scale_rel,
            f"{tag} off its plain version")
    return err


def phase_kernels(cfg) -> dict:
    """Every kernel against its plain version at the main paths' shapes."""
    from hirest_tpu_torch.ops.attention import (fused_attention_qkv3,
                                                fused_attention_qkv3_ref)
    from hirest_tpu_torch.ops.quant import (fused_mlp_int8,
                                            fused_mlp_int8_ref, ln_quant,
                                            ln_quant_ref)

    scale, heads = cfg.head_width ** -0.5, cfg.num_heads
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for batch in (2, BATCH):
        qkv = attention_inputs(batch, seed=batch)
        got = fused_attention_qkv3(qkv, scale, heads)
        torch.cuda.synchronize()
        want = fused_attention_qkv3_ref(qkv, scale, heads)
        err = (got.float() - want.float()).abs().max().item()
        # 2^-7 of the output's largest magnitude, one to two bf16 ulps
        # there: p may round the other way at a bf16 boundary under another
        # summation order, and the output rounds once to bf16
        tol = 2 ** -7 * want.float().abs().max().item()
        rel = err / want.float().abs().max().item()
        print(f"[kernels] K1 fused_attention_qkv3 B={batch}: "
              f"max_abs_err={err} max_err/max|ref|={rel} tol={tol}")
        require(bool(got.isfinite().all()) and err <= tol,
                f"fused_attention_qkv3 B={batch} off its plain version")
        worst["K1"] = max(worst["K1"], err)

    # K3: codes within one, equal on 99 %, scales within 2^-7 (p is rounded
    # to bf16 and may round the other way under another summation order)
    for batch, tokens, n_real in ((2, TOKENS, 0), (2, 264, TOKENS),
                                  (BATCH, TOKENS, 0)):
        qkv = attention_inputs(batch, seed=10 + batch + tokens, tokens=tokens)
        got = fused_attention_qkv3(qkv, scale, heads, quant_out=True,
                                   n_real=n_real)
        want = fused_attention_qkv3_ref(qkv, scale, heads, quant_out=True,
                                        n_real=n_real)
        worst["K3"] = max(worst["K3"], check_codes(
            f"K3 attention quant_out [{batch},{tokens},4224] n_real={n_real}",
            got, want, 0.99, 2 ** -7))

    # K2: codes within one, equal on 99.9 %, scales within 1e-6 (the row
    # reductions run in another order; rsqrtf is not correctly rounded)
    for batch in (2, BATCH):
        x, w, b = ln_inputs(batch * TOKENS, seed=20 + batch)
        worst["K2"] = max(worst["K2"], check_codes(
            f"K2 ln_quant [{batch * TOKENS},1408]", ln_quant(x, w, b, EPS),
            ln_quant_ref(x, w, b, EPS), 0.999, 1e-6))

    # K4: within 1e-2 of the MLP's largest contribution max|want - x| plus
    # one bf16 ulp of |want|, element by element: a hidden code that lands
    # on the other side of a rounding boundary moves a row by far less
    for batch in (2, BATCH):
        args = mlp_inputs(batch * TOKENS, seed=30 + batch)
        for act in ("gelu_poly", "gelu"):
            got = fused_mlp_int8(*args, act=act)
            torch.cuda.synchronize()
            want = fused_mlp_int8_ref(*args, act=act).float()
            contrib = (want - args[-1].float()).abs().max().item()
            ulp = torch.ldexp(torch.ones_like(want),
                              torch.frexp(want)[1] - 8)
            excess = ((got.float() - want).abs() - 1e-2 * contrib - ulp)
            err = (got.float() - want).abs().max().item()
            print(f"[kernels] K4 fused_mlp_int8 [{batch * TOKENS},1408]x6144 "
                  f"act={act}: max_abs_err={err} max|want-x|={contrib} "
                  f"worst excess over the bar={excess.max().item()}")
            require(bool(got.isfinite().all()) and excess.max().item() <= 0,
                    f"fused_mlp_int8 [{batch * TOKENS}] {act} off its plain "
                    f"version")
            worst["K4"] = max(worst["K4"], err)
    return worst


def run_videos(cfg, encoders: dict, frames: dict, tag: str) -> tuple:
    """Every synthetic video through each encoder, with the launch counts
    zeroed before and read after. Returns (features, counts, forwards)."""
    from hirest_tpu_torch.extraction.features import finish_video_features

    zero_counts()
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
    counts = read_counts()
    print(f"[main] {tag}: {forwards} forwards of {BATCH} frames in "
          f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    for vid, (n, duration) in VIDEOS.items():
        f, fu = feats[False, vid], feats[True, vid]
        want = (round(duration), cfg.embed_dim)
        require(f.shape == want and fu.shape == want,
                f"{tag} {vid}: shape {f.shape}/{fu.shape}, expected {want}")
        require(bool(np.isfinite(f).all() and np.isfinite(fu).all()),
                f"{tag} {vid}: non-finite features")
        require(bool(np.allclose(np.linalg.norm(f, axis=-1), 1, atol=1e-3)
                     and np.allclose(np.linalg.norm(fu, axis=-1), 1,
                                     atol=1e-3)),
                f"{tag} {vid}: features not L2-normalized")
        cos = cosine(f, fu).min()
        print(f"[main] {tag} {vid}: {f.shape} finite, unit norm; "
              f"min cosine float vs uint8 front end = {cos:.6f}")
        require(cos >= COS_MIN, f"{tag} {vid}: uint8 front end off the "
                                f"float one")
    return feats, counts, forwards


def phase_main(cfg, pretrained: Path) -> dict:
    """The extraction encoders on a few videos: bf16 then int8, each with
    the float and the uint8 front end."""
    from hirest_tpu_torch.extraction.features import make_eva_encoder

    rng = np.random.default_rng(0)
    frames = {v: rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
              for v, (n, _) in VIDEOS.items()}
    encoders, launches, feats = {}, {}, {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        t0 = time.perf_counter()
        encoders[tag] = {u8: make_eva_encoder(str(pretrained), int8=int8,
                                              uint8_frontend=u8,
                                              device="cuda")[0]
                         for u8 in (False, True)}
        print(f"[main] {tag}: two full-width encoders staged in "
              f"{time.perf_counter() - t0:.1f} s")
        feats[tag], counts, fw = run_videos(cfg, encoders[tag], frames, tag)
        want = ({"K1": 0, "K2": 2 * cfg.layers * fw, "K3": cfg.layers * fw,
                 "K4": cfg.layers * fw} if int8 else
                {"K1": cfg.layers * fw, "K2": 0, "K3": 0, "K4": 0})
        require(counts == want, f"{tag} launches {counts}, expected {want}")
        launches.update({k: v for k, v in counts.items() if want[k]})
    cos = min(cosine(feats["int8"][False, v], feats["bf16"][False, v]).min()
              for v in VIDEOS)
    print(f"[main] int8 vs bf16 features (float front end): min cosine "
          f"{cos:.6f}")
    return {"launches": launches, "encoders": encoders, "frames": frames}


def phase_depth(cfg, pretrained: Path) -> None:
    """The same weights at 2 layers: the card's bf16 and int8 forwards
    against the plain path on the CPU in f32."""
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

    def run(device, int8):
        dtype = torch.bfloat16 if device == "cuda" else torch.float32
        out = build_scanned_vision_apply(sd, cut, int8=int8, device=device,
                                         dtype=dtype)(frames)
        return out.cpu().numpy()

    cpu_float, cpu_int8 = run("cpu", False), run("cpu", True)
    for int8, ref, bar, what in (
            (False, cpu_float, COS_MIN, "bf16 card vs f32 CPU plain"),
            (True, cpu_int8, COS_MIN, "int8 bf16 card vs int8 f32 CPU plain"),
            (True, cpu_float, COS_INT8_VS_FLOAT,
             "int8 bf16 card vs float f32 CPU plain")):
        got = run("cuda", int8)
        cos = cosine(got, ref)
        print(f"[depth] 2 layers, {what}: cosine min={cos.min():.6f} "
              f"(>= {bar})")
        require(got.shape == (4, cfg.embed_dim) and bool(cos.min() >= bar),
                f"2-layer {what} below {bar}")


def time_encoders(main: dict, card: str) -> dict:
    out = {}
    for tag, encoders in main["encoders"].items():
        for u8, enc in encoders.items():
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
            print(f"[timing] {card}: {tag} encoder ({name} front end, host "
                  f"frames in) B={BATCH}: {fps:.2f} frames/s")
            out[f"fps_{tag}_{name}"] = fps
    # every projection as an int8 product, at the dense int8 peak
    proj_ops = 2 * BATCH * TOKENS * 40 * 1408 * (4224 + 1408 + 2 * 6144)
    print(f"[timing] int8 projections {proj_ops / 1e12:.1f} TOP per forward: "
          f"at {INT8_OP_PER_S / 1e12:.0f} TOP/s the card cannot pass "
          f"{BATCH * INT8_OP_PER_S / proj_ops:.0f} frames/s")
    return out


def phase_timing(cfg, main: dict, card: str) -> dict:
    """Frames/s, and each kernel's ms beside its plain version, a library
    yardstick and the bound, at the main path's B=128 shapes."""
    import torch.nn.functional as F

    from hirest_tpu_torch.ops.attention import (fused_attention_qkv3,
                                                fused_attention_qkv3_ref)
    from hirest_tpu_torch.ops.quant import (fused_mlp_int8,
                                            fused_mlp_int8_ref, ln_quant,
                                            ln_quant_ref)

    time_encoders(main, card)
    res = {}
    scale, heads, d = cfg.head_width ** -0.5, cfg.num_heads, cfg.head_width
    m, w, hid = BATCH * TOKENS, cfg.width, cfg.mlp_hidden

    qkv = attention_inputs(BATCH, seed=7)
    b, s, three_hd = qkv.shape
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn_flops = 2 * 2 * b * heads * s * s * d  # QK^T and PV
    res["K1"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv3(qkv, scale, heads), 20),
        "plain_ms": cuda_ms(
            lambda: fused_attention_qkv3_ref(qkv, scale, heads), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20),
        **bound(qkv.numel() * 2 + m * w * 2, attn_flops, BF16_FLOP_PER_S)}
    res["K3"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv3(
            qkv, scale, heads, quant_out=True), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv3_ref(
            qkv, scale, heads, quant_out=True), 5),
        "library_ms": None,
        **bound(qkv.numel() * 2 + m * w + m * 4, attn_flops,
                BF16_FLOP_PER_S)}

    x, g, bb = ln_inputs(m, seed=8)
    res["K2"] = {
        "ms": cuda_ms(lambda: ln_quant(x, g, bb, EPS), 20),
        "plain_ms": cuda_ms(lambda: ln_quant_ref(x, g, bb, EPS), 5),
        "library_ms": None,
        # about 8 f32 operations an element (LayerNorm, scale, code)
        **bound(m * w * 2 + m * w + m * 4 + 2 * w * 4, 8 * m * w,
                F32_FLOP_PER_S)}

    args = mlp_inputs(m, seed=9)
    h_q, _, w1_q, _, _, w2_q, _, _, x_res = args
    hidden_q = torch.randint(-127, 128, (m, hid), dtype=torch.int8,
                             device="cuda", generator=gen(10))
    res["K4"] = {
        "ms": cuda_ms(lambda: fused_mlp_int8(*args), 5),
        "plain_ms": cuda_ms(lambda: fused_mlp_int8_ref(*args), 3),
        # the floor a library would give: its two products as torch._int_mm
        "library_ms": cuda_ms(lambda: (torch._int_mm(h_q, w1_q.t()),
                                       torch._int_mm(hidden_q, w2_q.t())), 5),
        **bound(m * w + m * 4 + 2 * m * w * 2 + 2 * hid * w
                + 4 * (2 * hid + 2 * w), 2 * 2 * m * w * hid, INT8_OP_PER_S)}
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[timing] {card}: {name} B={BATCH}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res


KERNEL_GROUPS = {  # precision -> (group, substrings of a device kernel's name)
    "bf16": (
        ("K1 attention_qkv3 (CUDA)", ("attention_qkv3",)),
        ("projections (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
        ("layer_norm", ("layer_norm",)),
        ("elementwise (GELU chain, casts, bias, residual)",
         ("elementwise", "reduce")),
    ),
    "int8": (
        ("K2 ln_quant (CUDA)", ("ln_quant",)),
        ("K3 attention_qkv3 int8 epilogue (CUDA, both steps)",
         ("attention_qkv3", "attention_quant_rows")),
        ("K4 fused_mlp_int8 (CUDA)", ("fused_mlp_int8",)),
        ("int8 qkv/out GEMMs (torch._int_mm)",
         ("nvjet", "gemm", "cutlass", "xmma", "imma")),
        ("elementwise (int8_mm dequant epilogue, residual, casts)",
         ("elementwise", "reduce")),
    ),
}


def profile_forward(tag: str, enc, batch: np.ndarray, card: str) -> None:
    """One forward's device kernels by group from torch.profiler, and the
    device's idle share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enc(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    kernels: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        group = next((g for g, keys in KERNEL_GROUPS[tag]
                      if any(k in e.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        kernels[e.key] = kernels.get(e.key, 0.0) + ms
    busy = sum(groups.values())
    print(f"[profile] {card}: one {tag} forward B={BATCH}: wall "
          f"{wall_ms:.2f} ms (profiled), device busy {busy:.2f} ms, idle "
          f"share {1 - busy / wall_ms:.4f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {g}: {ms:.2f} ms ({ms / busy:.4f} of busy)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]     kernel {name[:110]}: {ms:.2f} ms")


def phase_profile(cfg, main: dict, card: str) -> None:
    """Where one float-front-end forward's time goes, for each precision,
    and each plain per-layer op timed alone at the main path's shapes with
    CUDA events."""
    import torch.nn.functional as F

    from hirest_tpu_torch.models.eva_clip import layer_norm
    from hirest_tpu_torch.models.layers import gelu_bf16_poly
    from hirest_tpu_torch.ops.quant import int8_mm

    batch = normalize_frames(main["frames"]["vid_a"][:BATCH])
    for tag, encoders in main["encoders"].items():
        profile_forward(tag, encoders[False], batch, card)

    m, w, hid = BATCH * TOKENS, cfg.width, cfg.mlp_hidden
    g = gen(3)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02
                ).to(torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8,
                             device="cuda", generator=g)

    x, h = rnd(m, w) * 50, rnd(m, hid) * 50
    wq, bq, wp, bp = rnd(3 * w, w), rnd(3 * w), rnd(w, w), rnd(w)
    w1, b1, w2, b2 = rnd(hid, w), rnd(hid), rnd(w, hid), rnd(w)
    norm = torch.nn.LayerNorm(w, device="cuda")
    x_q, x_s = codes(m, w), torch.rand((m, 1), device="cuda", generator=g)
    qkv_q, out_q = codes(3 * w, w), codes(w, w)
    qkv_s = torch.rand(3 * w, device="cuda", generator=g)
    out_s = torch.rand(w, device="cuda", generator=g)
    ops = {
        "qkv linear [M,1408]x[1408,4224]": lambda: F.linear(x, wq, bq),
        "proj linear [M,1408]x[1408,1408]": lambda: F.linear(x, wp, bp),
        "fc1 linear [M,1408]x[1408,6144]": lambda: F.linear(x, w1, b1),
        "fc2 linear [M,6144]x[6144,1408]": lambda: F.linear(h, w2, b2),
        "gelu_bf16_poly [M,6144]": lambda: gelu_bf16_poly(h),
        "layer_norm (f32) [M,1408]": lambda: layer_norm(x, norm),
        "_int_mm qkv [M,1408]x[1408,4224]": lambda: torch._int_mm(x_q,
                                                                  qkv_q.t()),
        "int8_mm qkv (product + dequant epilogue)": lambda: int8_mm(
            x_q, x_s, qkv_q, qkv_s, bq, torch.bfloat16),
        "_int_mm out [M,1408]x[1408,1408]": lambda: torch._int_mm(x_q,
                                                                  out_q.t()),
        "int8_mm out (product + dequant epilogue)": lambda: int8_mm(
            x_q, x_s, out_q, out_s, bp, torch.bfloat16),
    }
    for name, fn in ops.items():
        print(f"[profile] {card}: {name}, M={m}: "
              f"{cuda_ms(fn, 10):.4f} ms per call")


SOURCES = {  # kernel -> (wrapper name, source, TPU kernel it replaces)
    "K1": ("fused_attention_qkv3",
           "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:471"),
    "K2": ("ln_quant", "hirest_tpu_torch/ops/csrc/ln_quant.cu",
           "hirest_tpu/ops/quant.py:145"),
    "K3": ("fused_attention_qkv3(quant_out=True)",
           "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:502"),
    "K4": ("fused_mlp_int8", "hirest_tpu_torch/ops/csrc/fused_mlp_int8.cu",
           "hirest_tpu/ops/quant.py:296"),
}


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

    errs = phase_kernels(cfg)
    main_res = phase_main(cfg, pretrained)
    phase_depth(cfg, pretrained)
    timing = phase_timing(cfg, main_res, card)
    phase_profile(cfg, main_res, card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": main_res["launches"][k], "max_abs_err": errs[k],
        **timing[k]} for k, (name, src, replaces) in SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
