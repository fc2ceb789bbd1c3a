#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hirest_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # needs one CUDA GPU and nvcc
    python3 chip_smoke.py --kernels-only  # build and kernels phases only
    python3 chip_smoke.py --time-attention  # K1, K3, K6-K9 ms alone
    python3 chip_smoke.py --time-mlp        # K4 and its _int_mm pair alone
    python3 chip_smoke.py --time-rows       # K2, K5, K10 ms alone

--time-attention times K1 and K3 (head widths 88 and 128; K1 also at 192
tokens, one 192-row query tile a head), K9, K6, K7 and K8 (bf16 and int8
out), beside scaled_dot_product_attention, and nothing else, so a copy of
this file run from a `git archive` of an earlier commit times that
commit's kernels: run parent, change, change, parent in one call to
compare two trees on one card. Where attention_split.cu has its
arithmetic variants (HIREST_SPLIT_ARITH), it also times K6 and K7 under
each (exp2f or expf for ex2.approx.ftz, __fdiv_rn for the reciprocal
multiply), each held against its plain version. --time-mlp does the same
for K4 at B=128 (through fused_mlp_int8, which every version of the port
has), beside its two products as torch._int_mm; where the checkout splits
K4 into two kernels it also times the first alone. --time-rows does the
same for K2, K5 (gelu_bf16_poly at 6144, none at 1408) and K10 beside
F.layer_norm and a clone of K10's bytes, and K5 on the fc1 outputs of an
int8+fq+v3 forward; it first runs row_checks (each case's codes that
differ from the plain version), then measures where K2's time spreads
(the clocks, the kernel's own time against the host's, x in L2 or
not) and prints the row kernels' SASS counts. The flags combine: one
process runs each asked for.

Phases; any failure exits non-zero before the result line is printed:

1. build    compile every CUDA kernel of the port from this checkout (set-up);
            K4's two kernels', K1/K3's, K5's and K2/K10's instantiations'
            registers, spills and shared memory.
2. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, at the main paths' shapes: K1 and K3 (attention qkv
            [B, S, 4224] bf16; K3 also padded to S = 264 with n_real = 257;
            both again at the padded head width, [B, 257, 6144]; and both,
            at both widths, at the tiles' edges, their errors printed
            apart: 33 and 65 tokens, 592 (d = 88) and 432 (d = 128)
            tokens, 264 with n_real = 257 at B = 2 and 128), K4
            (fused_mlp_int8, [M, 1408] x 6144,
            both activations; its first kernel's codes and scales also
            against mlp_int8_hidden_ref, equal), K6 (split heads
            [B, 16, 257, 88] as views of one qkv projection, and a masked
            [2, 12, 48, 64] over 20 keys)
            and K7 (packed [B, 257, 16 * 128], and a masked 48 x 20-key
            shape), each also with one batch row's keys all masked and
            with 33 queries over 600 keys (d = 88 masked, d = 128), K8
            (v1, [B, 257, 4224] with nonzero q/v biases, bf16 and
            int8 out; also [2, 257, 6144] at d = 128 and [2, 600, 4224]),
            the streamed body's blocks an SM for K6/K7's, K8's and K8
            int8's instantiations, K9
            (v2, bf16 and int8 out, and int8 padded to S = 264 with
            n_real = 257), B = 2 and 128, M = 257 B; then row_checks: K2
            (ln_quant, [2 * 257 and M, 1408]), K5 (act_quant, [M, 6144]
            with both GELUs, [M, 1408] without one) and K10 (ln_bf16,
            [M, 1408]), each also at M = 1, 2, 257 and 5000 (not a
            multiple of the persistent grid's rows) with a row of zeros,
            K5 on rows whose quotients land on k + 1/2, and the row
            kernels' quotients y / s against PyTorch's IEEE division on every
            element.
3. main     the extraction encoder at full EVA-g width (40 layers, 1408 wide,
            seeded random weights): make_eva_encoder(device="cuda"), bf16 and
            int8=True, each with the float and the uint8 front end, a few
            synthetic videos through the per-video finish of
            extract_video_features. Every launch count is zeroed before each
            precision's run and read after it: per forward, the bf16 path
            launches K1 40 times and no other kernel; the int8 path launches
            K2 80 times, K3 and K4 40 times each, and no other.
4. factory  build_eva_model_and_transforms(device="cuda") at full width
            (text 12 x 768, vision 40 x 1408; one draw of seeded random
            weights shared by every build): encode_text on 512 prompts, and
            encode_image at B = 128 unrolled (scan=False: 40 K6 a forward),
            padded unrolled (40 K7), padded scanned (40 K1 at head width
            128) and padded scanned int8 (80 K2, 40 K3 at 128, 40 K4), each
            with the counts zeroed before and read after, and no other
            kernel launched.
5. ladder   the kernel flag configurations of build_scanned_vision_apply
            (bench.py's ladder without its TPU layout flags) at full width
            on one staged bf16 and one staged int8 tower: bf16 (v1, K8),
            bf16+v2 (K9), bf16+v3+lnk (K1, K10), int8 dyn (K8), int8+fq
            (K2, K5, K8 int8), int8+fq+v2 (K2, K5, K9 int8) and int8+fq+v3
            (K2, K3, K5), two forwards each with the counts zeroed before
            and read after; each one's 2-layer cut on the card against the
            CPU f32 path with the same flags.
6. depth    the same weights cut to 2 layers, on the card in bf16 against the
            plain path on the CPU in f32: bf16 vs float at cosine >= 0.99;
            int8 vs int8 at >= 0.99 and int8 vs float at >= 0.98; the text
            tower, the unrolled tower, and the padded unrolled and padded
            scanned towers against the unpadded CPU paths at >= 0.99.
7. timing   frames/s at B=128 for every encoder, factory and ladder
            forward, text prompts/s, and each kernel's ms per call beside
            its plain version, one library call computing the same function
            (or its int8 products, for K4), and the card's bound.
8. profile  where one forward's device time goes, by group of kernels, and
            the device's idle share, for each precision, the unrolled
            towers and the ladder's bf16, int8 and int8+fq (K8) and
            int8+fq+v3 (K5) forwards;
            each plain per-layer op timed alone.
9. serving  the serving path at full width over phase 3's int8 features
            (written as .npy): the engine as `python -m
            hirest_tpu_torch.serve` builds it on the card (EVA-CLIP-g text
            tower 12 x 768, MomentModel at JointModelConfig(), seeded
            random weights, 5 beams of 48 words, f32), warmup, then
            retrieve and analyze on every video, directly and through the
            HTTP server on 127.0.0.1, port 0, and analyze again with
            fused_segmentation, with every launch count 0 during the
            requests (the serving path runs no kernel of the port, as the
            JAX one runs no Pallas kernel); bounds inside the video, steps
            sorted; p50/p95 of retrieve and analyze over 20 rounds (each
            prompt retrieved, each video analyzed in both segmentation
            modes, one after the other), pooled and per video; analyze's
            split (text encode, moment retrieval, segmentation iterations,
            beam decode, host rest) over 5 requests a video, and one
            request's device time and idle share from the profiler, in
            each mode. Then one analyze request a video and prompt against
            the port's CPU f32 engine, within 1e-5 of the CPU value's
            largest magnitude: moment-retrieval and segmentation logits,
            the served captioning batch's caption_encode, and each
            decode_step of the CPU's beam replayed on the card from the
            CPU's inputs; bounds equal; the two beams make the same choice
            at every step (a choice may differ only where the CPU's
            candidates lie closer than the measured differences can move
            them, and then the caption is not held), and end on the same
            captions. The served (cached) beam against the full re-decode
            beam on the card: the full decoder's logits at the served
            prefixes within 1e-5, and the same choices and captions.

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
PADDED_HD = 16 * 128  # the padded heads' width (models/eva_pad.py)
PROMPTS = 512  # text prompts through encode_text, in batches of BATCH
TEXT_BATCH = 256  # prompts per encode_text call when timed
FACTORY_FORWARDS = 2  # image forwards of B=128 per factory configuration
# synthetic videos: frame count and duration in seconds (truncation target)
VIDEOS = {"vid_a": (200, 199.6), "vid_b": (90, 88.4), "vid_c": (17, 17.0)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak
# f32 issue slots: 132 SMs x 4 schedulers x 32 lanes at the 1.98 GHz boost
# clock. __fmul_rn / __fadd_rn issue one slot each, never paired as FMAs.
ISSUE_SLOTS_PER_S = 132 * 4 * 32 * 1.98e9
# The issue slots a value that each row kernel's function needs (K2, K5,
# K10; PERF.md §2), counted from the arithmetic, not from a build: the bf16
# widening 1; gelu_bf16_poly 22 (gelu.cuh: 11 FMUL, 7 FADD, 4 FMNMX); the
# LayerNorm 7 (the sum, the centring, the square and its sum, x r g + b);
# the int8 quantization 5.75 (|y|'s max, y / s in three instructions, the
# rounding, four codes packed by three); bf16 out 0.5 (two values a
# pack). A row's reductions and scale, once a row, are left out.
ROW_SLOTS = {"K5 gelu_poly": 1 + 22 + 5.75, "K5 none": 1 + 5.75,
             "K2": 1 + 7 + 5.75, "K10": 1 + 7 + 0.5}
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
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv3)
    from hirest_tpu_torch.ops.quant import (act_quant, fused_mlp_int8,
                                            ln_bf16, ln_quant)

    return {"K1": (fused_attention_qkv3, "launches"),
            "K2": (ln_quant, "launches"),
            "K3": (fused_attention_qkv3, "quant_launches"),
            "K4": (fused_mlp_int8, "launches"),
            "K5": (act_quant, "launches"),
            "K6": (fused_attention, "launches"),
            "K7": (fused_attention_packed, "launches"),
            "K8": (fused_attention_qkv, "launches"),
            "K8q": (fused_attention_qkv, "quant_launches"),
            "K9": (fused_attention_qkv2, "launches"),
            "K9q": (fused_attention_qkv2, "quant_launches"),
            "K10": (ln_bf16, "launches")}


def expect(**per_forward) -> dict:
    """Every kernel's expected count: the given ones, and 0 for the rest."""
    return {k: per_forward.get(k, 0) for k in counters()}


def zero_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def attention_inputs(batch: int, seed: int, tokens: int = TOKENS,
                     hd: int = 1408):
    # std 0.75: what the trunk's qkv projection gives with 0.02 weights
    return (torch.randn((batch, tokens, 3 * hd), generator=gen(seed),
                        device="cuda") * 0.75).to(torch.bfloat16)


def split_views(qkv, heads: int = 16):
    """q, k, v as the unrolled tower's split_heads gives them: [B, H, S, d]
    views of one [B, S, 3 H d] projection, no copy."""
    from hirest_tpu_torch.models.layers import split_heads

    return [split_heads(t, heads) for t in qkv.chunk(3, -1)]


def masked_inputs(seed: int, sq: int = 48, sk: int = 20,
                  valid: tuple = (15, 15), heads: int = 12, d: int = 64):
    """The caption decoder's cross-attention shape: q [B, H, sq, d] over
    k/v [B, H, sk, d], B = len(valid), batch row i's keys from valid[i] on
    masked."""
    g = gen(seed)
    q, k, v = (torch.randn((len(valid), heads, n, d), generator=g,
                           device="cuda").to(torch.bfloat16)
               for n in (sq, sk, sk))
    keys = torch.arange(sk, device="cuda")
    mask = torch.stack([keys < n for n in valid]).int()
    return q, k, v, mask


def ln_inputs(m: int, seed: int, c: int = 1408):
    """A residual stream with a per-row spread and offset, LayerNorm params
    near (1, 0)."""
    g = gen(seed)
    x = (torch.randn((m, c), generator=g, device="cuda")
         * torch.rand((m, 1), generator=g, device="cuda").mul_(2.5).add_(0.5)
         + torch.randn((m, 1), generator=g, device="cuda")).bfloat16()
    w = 1 + 0.02 * torch.randn(c, generator=g, device="cuda")
    b = 0.02 * torch.randn(c, generator=g, device="cuda")
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


def check_codes(tag: str, got, want, min_equal: float, scale_rel: float,
                tally: dict | None = None, key: str = ""):
    """Quantized outputs (codes, scales) against the plain version's: codes
    within one and equal on min_equal of them, scales within scale_rel.
    Returns the largest error of the dequantized values; adds the count of
    differing codes to tally[key] where a tally is given."""
    (q, s), (rq, rs) = got, want
    torch.cuda.synchronize()
    diff = (q.int() - rq.int()).abs()
    n_diff = int((diff != 0).sum().item())
    equal = 1 - n_diff / diff.numel()
    rel = ((s - rs).abs() / rs.abs()).max().item()
    err = (q.float() * s - rq.float() * rs).abs().max().item()
    print(f"[kernels] {tag}: max|dcode|={diff.max().item()} "
          f"{n_diff} of {diff.numel()} codes differ, equal={equal:.6f} "
          f"(>= {min_equal}) scale rel={rel:.3e} (<= {scale_rel:.3e}) "
          f"max_abs_err={err}")
    require(bool(s.isfinite().all()) and diff.max().item() <= 1
            and equal >= min_equal and rel <= scale_rel,
            f"{tag} off its plain version")
    if tally is not None:
        tally[key] = tally.get(key, 0) + n_diff
    return err


def biases(hd: int, seed: int):
    """Nonzero q and v biases [hd], of the qkv values' size."""
    g = gen(seed)
    return [(torch.randn(hd, generator=g, device="cuda") * 0.5).bfloat16()
            for _ in range(2)]


def fc1_inputs(m: int, seed: int, c: int = 6144):
    """What the int8 MLP hands act_quant: an fc1 output with a per-row
    spread (or, at c = 1408, an attention output)."""
    g = gen(seed)
    return (torch.randn((m, c), generator=g, device="cuda")
            * torch.rand((m, 1), generator=g, device="cuda").mul_(2.5)
            .add_(0.5)).bfloat16()


def check_close(tag: str, got, want) -> float:
    """A bf16 attention output against its plain version: within 2^-7 of
    the output's largest magnitude, one to two bf16 ulps there (p may round
    the other way at a bf16 boundary under another summation order, and the
    output rounds once to bf16). Returns the largest error."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    print(f"[kernels] {tag}: max_abs_err={err} max_err/max|ref|={err / top} "
          f"tol={2 ** -7 * top}")
    require(bool(got.isfinite().all()) and err <= 2 ** -7 * top,
            f"{tag} off its plain version")
    return err


ROW_EDGE_M = (1, 2, 257, 5000)  # 5000: not a multiple of any grid's rows


def ln_bf16_differ(tag: str, x, w, b) -> tuple:
    """K10 against its plain version: within one bf16 ulp of each output
    plus 1e-5 (the row reductions run in another order and rsqrtf is not
    correctly rounded, which moves the f32 LayerNorm by ~1e-6; where
    (x - mean) r g cancels against b, that is many bf16 ulps of an output
    near zero). Returns the largest error and the count of outputs more
    than one ulp off."""
    from hirest_tpu_torch.ops.quant import ln_bf16, ln_bf16_ref

    got, want = ln_bf16(x, w, b, EPS), ln_bf16_ref(x, w, b, EPS)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    ulp = torch.ldexp(torch.ones_like(diff),
                      torch.frexp(want.float())[1] - 8)
    off = diff > ulp
    n_off = int(off.sum().item())
    top = want.float().abs()[off].max().item() if n_off else 0.0
    err = diff.max().item()
    print(f"[kernels] {tag}: max_abs_err={err}; {n_off} of {diff.numel()} "
          f"outputs more than one bf16 ulp off, all with |want| <= {top}, "
          f"by at most {(diff - ulp).max().item()} over the ulp (<= 1e-5)")
    require(bool(got.isfinite().all()) and bool((diff <= ulp + 1e-5).all()),
            f"{tag} off its plain version")
    return err, n_off


def tie_rows(c: int = 1408) -> torch.Tensor:
    """[5, c] bf16 rows for act "none": two whose max |y| is 127 (scale 1)
    with every other value on k + 1/2 (-126.5 .. 126.5, which must round
    to even), a row of zeros (scale 1e-8, codes 0) and two random rows."""
    halves = torch.arange(c - 1, device="cuda") % 254 - 126.5
    rows = torch.zeros((5, c), device="cuda")
    rows[0, 0], rows[0, 1:] = 127.0, halves
    rows[1, 0], rows[1, 1:] = -127.0, -halves.flip(0)
    rows[3:] = torch.randn((2, c), generator=gen(400), device="cuda")
    return rows.bfloat16()


def quotients_differ(tag: str, y, s, tally: dict) -> None:
    """The row kernels' y / s (row_quotient, rowquant.cuh) against PyTorch's
    IEEE division on the card, on every element of the plain version's f32
    y [..., C] and scales s [..., 1]: they must be equal. Skipped in a
    checkout whose act_quant.cu has no hirest_row_quotients."""
    import ctypes

    from hirest_tpu_torch.ops import build

    lib = build.load("act_quant")
    if not hasattr(lib, "hirest_row_quotients"):
        return
    fn = lib.hirest_row_quotients
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = y.reshape(-1, y.shape[-1]).contiguous()
    s = s.reshape(-1, 1).contiguous()
    fast = torch.empty_like(y)
    build.check(lib, fn(y.data_ptr(), s.data_ptr(), fast.data_ptr(),
                        y.shape[0], y.shape[1],
                        torch.cuda.current_stream().cuda_stream),
                "row_quotients launch")
    n = int((fast != y / s).sum().item())
    tally["quotients"] = tally.get("quotients", 0) + n
    print(f"[kernels] {tag}: {n} of {y.numel()} quotients y / s differ "
          f"from PyTorch's IEEE division (bar 0)")
    require(n == 0, f"{tag}: row_quotient off the IEEE quotient")


def row_checks(tag: str = "kernels") -> tuple:
    """K2, K5 and K10 against their plain versions: at the main paths'
    shapes (K2 [2 * 257 and M, 1408]; K5 [M, 6144] with each GELU and
    [M, 1408] with none; K10 [M, 1408]; M = 128 * 257), then at the
    persistent grid's edges, M in ROW_EDGE_M (a row of zeros in the
    257-row inputs: scale 1e-8, codes 0, and for K2 with b = 0), and K5 on
    rows whose quotients land on k + 1/2 (equal to the plain version and
    to half-even rounding), and the general instantiations at widths
    1024 to 8192. K2 and K5: codes within one, equal on 99.9 %,
    scales within 1e-6; K10: ln_bf16_differ's bar. Prints each case and a
    total a kernel of the codes (K10: outputs beyond one ulp) that differ
    from the plain version, which this file copied into an earlier
    checkout prints for that checkout's kernels on the same inputs.
    Returns (the main shapes' largest errors, the totals)."""
    from hirest_tpu_torch.ops.quant import (QUANT_ACTS, _act, _ln_f32,
                                            act_quant, act_quant_ref,
                                            ln_quant, ln_quant_ref)

    m = BATCH * TOKENS
    worst = {"K2": 0.0, "K5": 0.0, "K10": 0.0}
    tally: dict = {}
    tiny = torch.tensor(1e-8, dtype=torch.float32).item()
    for rows in (2 * TOKENS, m, *ROW_EDGE_M):
        main = rows in (2 * TOKENS, m)
        x, w, b = ln_inputs(rows, seed=20 + rows // TOKENS if main
                            else 300 + rows)
        if rows == TOKENS:
            x[5], b = 0, torch.zeros_like(b)
        got, want = ln_quant(x, w, b, EPS), ln_quant_ref(x, w, b, EPS)
        err = check_codes(f"K2 ln_quant [{rows},1408]", got, want, 0.999,
                          1e-6, tally, "K2")
        quotients_differ(f"K2 [{rows},1408]", _ln_f32(x, w, b, EPS),
                         want[1], tally)
        if rows == TOKENS:
            require(not got[0][5].any().item()
                    and got[1][5].item() == tiny, "K2 zero row")
        if main:
            worst["K2"] = max(worst["K2"], err)
    for c, acts in ((6144, ("gelu_poly", "gelu")), (1408, ("none",))):
        for rows in (m, *ROW_EDGE_M):
            x = fc1_inputs(rows, seed=70 + c if rows == m else 500 + rows,
                           c=c)
            if rows == TOKENS:
                x[7] = 0
            for act in acts:
                got, want = act_quant(x, act=act), act_quant_ref(x, act=act)
                err = check_codes(f"K5 act_quant [{rows},{c}] act={act}",
                                  got, want, 0.999, 1e-6, tally, f"K5 {act}")
                quotients_differ(f"K5 [{rows},{c}] act={act}",
                                 _act(act, QUANT_ACTS)(x.float()), want[1],
                                 tally)
                if rows == TOKENS:
                    require(not got[0][7].any().item()
                            and got[1][7].item() == tiny,
                            f"K5 {act} zero row")
                if rows == m:
                    worst["K5"] = max(worst["K5"], err)
    x = tie_rows()
    got, want = act_quant(x), act_quant_ref(x)
    check_codes("K5 act_quant [5,1408] act=none, halves", got, want, 0.999,
                1e-6, tally, "K5 none")
    halves = torch.round(x[:2, 1:].float()).to(torch.int8)
    quotients_differ("K5 [5,1408] act=none, halves", x.float(), want[1],
                     tally)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[0][:2, 1:], halves)
            and got[1][2].item() == tiny, "K5 halves off half-even")
    for rows in (m, *ROW_EDGE_M):
        x, w, b = ln_inputs(rows, seed=90 if rows == m else 600 + rows)
        err, n_off = ln_bf16_differ(f"K10 ln_bf16 [{rows},1408]", x, w, b)
        tally["K10"] = tally.get("K10", 0) + n_off
        if rows == m:
            worst["K10"] = err
    # the general instantiations, at widths other than EVA-g's (their own
    # total: the main paths' stay comparable across versions)
    for c in (1024, 2048):
        x, w, b = ln_inputs(TOKENS, seed=700 + c, c=c)
        check_codes(f"K2 ln_quant [{TOKENS},{c}]", ln_quant(x, w, b, EPS),
                    ln_quant_ref(x, w, b, EPS), 0.999, 1e-6, tally,
                    "other widths")
        tally["other widths"] += ln_bf16_differ(
            f"K10 ln_bf16 [{TOKENS},{c}]", x, w, b)[1]
    for c, act in ((1024, "none"), (2048, "gelu_poly"), (4096, "gelu"),
                   (8192, "gelu_poly")):
        x = fc1_inputs(TOKENS, seed=710 + c, c=c)
        check_codes(f"K5 act_quant [{TOKENS},{c}] act={act}",
                    act_quant(x, act=act), act_quant_ref(x, act=act), 0.999,
                    1e-6, tally, "other widths")
    print(f"[{tag}] differing from the plain version over these cases: "
          + ", ".join(f"{k} {n}" for k, n in tally.items())
          + " (K10: outputs beyond one bf16 ulp)")
    return worst, tally


def phase_kernels(cfg) -> dict:
    """Every kernel against its plain version at the main paths' shapes."""
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_packed_ref,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv2_ref,
                                                fused_attention_qkv3,
                                                fused_attention_qkv3_ref,
                                                fused_attention_qkv_ref,
                                                fused_attention_ref,
                                                split_occupancy)
    from hirest_tpu_torch.ops.quant import (_mlp_hidden_launch,
                                            fused_mlp_int8,
                                            fused_mlp_int8_ref,
                                            mlp_int8_hidden_ref)

    scale, heads = cfg.head_width ** -0.5, cfg.num_heads
    worst = {"K1": 0.0, "K3": 0.0, "K4": 0.0, "K6": 0.0, "K7": 0.0}
    for d in (88, 128):  # the native head width, and the padded one
        for batch in (2, BATCH):
            qkv = attention_inputs(batch, seed=batch + d - 88, hd=heads * d)
            err = check_close(
                f"K1 fused_attention_qkv3 d={d} B={batch}",
                fused_attention_qkv3(qkv, d ** -0.5, heads),
                fused_attention_qkv3_ref(qkv, d ** -0.5, heads))
            if d == 88:
                worst["K1"] = max(worst["K1"], err)

    # K3: codes within one, equal on 99 %, scales within 2^-7 (p is rounded
    # to bf16 and may round the other way under another summation order)
    for d, batch, tokens, n_real in ((88, 2, TOKENS, 0), (88, 2, 264, TOKENS),
                                     (88, BATCH, TOKENS, 0),
                                     (128, 2, TOKENS, 0),
                                     (128, BATCH, TOKENS, 0)):
        qkv = attention_inputs(batch, seed=10 + batch + tokens + d - 88,
                               tokens=tokens, hd=heads * d)
        got = fused_attention_qkv3(qkv, d ** -0.5, heads, quant_out=True,
                                   n_real=n_real)
        want = fused_attention_qkv3_ref(qkv, d ** -0.5, heads,
                                        quant_out=True, n_real=n_real)
        err = check_codes(
            f"K3 attention quant_out [{batch},{tokens},{3 * heads * d}] "
            f"n_real={n_real}", got, want, 0.99, 2 ** -7)
        if d == 88:
            worst["K3"] = max(worst["K3"], err)

    # K1 and K3 where the 64-row query tiles and 64-key tiles meet their
    # edges: 33 and 65 tokens (a tile and one more row or key), the longest
    # rows the staged first version took (592 at d=88, 432 at d=128), and
    # pad keys (n_real < S) with bf16 out, at B=2 and 128; same bars. Their
    # errors are printed apart: the kernels line keeps the main path's.
    edge = {"K1": 0.0, "K3": 0.0}
    for d, batch, tokens, n_real in (
            (88, 2, 33, 0), (88, 2, 65, 0), (128, 2, 33, 0), (128, 2, 65, 0),
            (88, 2, 592, 0), (128, 2, 432, 0), (88, 2, 264, TOKENS),
            (128, 2, 264, TOKENS), (88, BATCH, 264, TOKENS),
            (128, BATCH, 264, TOKENS)):
        qkv = attention_inputs(batch, seed=100 + batch + tokens + d,
                               tokens=tokens, hd=heads * d)
        shape = f"[{batch},{tokens},{3 * heads * d}] n_real={n_real}"
        edge["K1"] = max(edge["K1"], check_close(
            f"K1 fused_attention_qkv3 {shape}",
            fused_attention_qkv3(qkv, d ** -0.5, heads, n_real=n_real),
            fused_attention_qkv3_ref(qkv, d ** -0.5, heads, n_real=n_real)))
        edge["K3"] = max(edge["K3"], check_codes(
            f"K3 attention quant_out {shape}",
            fused_attention_qkv3(qkv, d ** -0.5, heads, quant_out=True,
                                 n_real=n_real),
            fused_attention_qkv3_ref(qkv, d ** -0.5, heads, quant_out=True,
                                     n_real=n_real), 0.99, 2 ** -7))
    print(f"[kernels] K1/K3 at the tiles' edges: K1 max_abs_err="
          f"{edge['K1']}, K3 max_abs_err (dequantized)={edge['K3']}")

    # K6 and K7 at K1's bar, on the unrolled towers' shapes: split-heads
    # views of one qkv projection (d=88), packed heads (d=128), and the
    # masked cross-attention shape in each layout
    for batch in (2, BATCH):
        q, k, v = split_views(attention_inputs(batch, seed=40 + batch))
        worst["K6"] = max(worst["K6"], check_close(
            f"K6 fused_attention [{batch},16,257,88]",
            fused_attention(q, k, v, scale), fused_attention_ref(q, k, v,
                                                                 scale)))
        q, k, v = attention_inputs(batch, seed=50 + batch,
                                   hd=PADDED_HD).chunk(3, -1)
        worst["K7"] = max(worst["K7"], check_close(
            f"K7 fused_attention_packed [{batch},257,16*128]",
            fused_attention_packed(q, k, v, 128 ** -0.5, heads),
            fused_attention_packed_ref(q, k, v, 128 ** -0.5, heads)))
    q, k, v, mask = masked_inputs(seed=60)
    worst["K6"] = max(worst["K6"], check_close(
        "K6 fused_attention [2,12,48,64] over 20 keys, 15 valid",
        fused_attention(q, k, v, 0.125, mask),
        fused_attention_ref(q, k, v, 0.125, mask)))
    q, k, v, mask = masked_inputs(seed=61, heads=16, d=128)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
    worst["K7"] = max(worst["K7"], check_close(
        "K7 fused_attention_packed [2,48,16*128] over 20 keys, 15 valid",
        fused_attention_packed(*packed, 128 ** -0.5, heads, mask),
        fused_attention_packed_ref(*packed, 128 ** -0.5, heads, mask)))
    # the streamed body's edges: a batch row whose keys are all masked
    # (uniform p, as -1e30 gives), and 600 keys (past what a staged head
    # fits in shared memory) over 33 queries (a 3-tile block, its last
    # tile one row)
    q, k, v, mask = masked_inputs(seed=62, valid=(15, 0))
    worst["K6"] = max(worst["K6"], check_close(
        "K6 fused_attention [2,12,48,64] over 20 keys, 15 and 0 valid",
        fused_attention(q, k, v, 0.125, mask),
        fused_attention_ref(q, k, v, 0.125, mask)))
    q, k, v, mask = masked_inputs(seed=63, valid=(15, 0), heads=16, d=128)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
    worst["K7"] = max(worst["K7"], check_close(
        "K7 fused_attention_packed [2,48,16*128] over 20 keys, 15 and 0 "
        "valid", fused_attention_packed(*packed, 128 ** -0.5, heads, mask),
        fused_attention_packed_ref(*packed, 128 ** -0.5, heads, mask)))
    q, k, v, mask = masked_inputs(seed=64, sq=33, sk=600, valid=(590, 600),
                                  heads=16, d=88)
    worst["K6"] = max(worst["K6"], check_close(
        "K6 fused_attention [2,16,33,88] over 600 keys, 590 and 600 valid",
        fused_attention(q, k, v, scale, mask),
        fused_attention_ref(q, k, v, scale, mask)))
    q, k, v, _ = masked_inputs(seed=65, sq=33, sk=600, heads=16, d=128)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
    worst["K7"] = max(worst["K7"], check_close(
        "K7 fused_attention_packed [2,33,16*128] over 600 keys",
        fused_attention_packed(*packed, 128 ** -0.5, heads),
        fused_attention_packed_ref(*packed, 128 ** -0.5, heads)))
    for d in (88, 128):
        for what, kind in (("K6/K7", {}), ("K8", dict(bias=True)),
                           ("K8 int8", dict(bias=True, quant=True))):
            occ = split_occupancy(d, TOKENS, **kind)
            print(f"[kernels] {what} streamed body, d={d}, Sq={TOKENS}: "
                  f"{occ['threads']} threads and {occ['smem_bytes']} bytes "
                  f"of shared memory a block, {occ['blocks_per_sm']} blocks "
                  f"an SM")

    # K4: within 1e-2 of the MLP's largest contribution max|want - x| plus
    # one bf16 ulp of |want|, element by element: a hidden code that lands
    # on the other side of a rounding boundary moves a row by far less.
    # Its first kernel's codes and scales must equal the plain version's
    # (a stage check: the products are exact and every f32 step rounds
    # where the plain version rounds)
    for batch in (2, BATCH):
        args = mlp_inputs(batch * TOKENS, seed=30 + batch)
        for act in ("gelu_poly", "gelu"):
            codes, scales = _mlp_hidden_launch(*args[:5], act)
            want_codes, want_scales = mlp_int8_hidden_ref(*args[:5], act=act)
            torch.cuda.synchronize()
            n_codes = int((codes != want_codes).sum().item())
            n_scales = int((scales != want_scales).sum().item())
            print(f"[kernels] K4 mlp_hidden [{batch * TOKENS},1408]x6144 "
                  f"act={act}: {n_codes} of {codes.numel()} codes and "
                  f"{n_scales} of {scales.numel()} scales differ (bar 0)")
            require(n_codes == 0 and n_scales == 0,
                    f"K4 mlp_hidden [{batch * TOKENS}] {act} off its plain "
                    f"version")
            got = fused_mlp_int8(*args, act=act)
            torch.cuda.synchronize()
            want = fused_mlp_int8_ref(*args, act=act).float()
            contrib = (want - args[-1].float()).abs().max().item()
            ulp = torch.ldexp(torch.ones_like(want),
                              torch.frexp(want)[1] - 8)
            excess = ((got.float() - want).abs() - 1e-2 * contrib - ulp)
            err = (got.float() - want).abs().max().item()
            n_out = int((got.float() != want).sum().item())
            print(f"[kernels] K4 fused_mlp_int8 [{batch * TOKENS},1408]x6144 "
                  f"act={act}: {n_out} of {got.numel()} outputs differ, "
                  f"max_abs_err={err} max|want-x|={contrib} "
                  f"worst excess over the bar={excess.max().item()}")
            require(bool(got.isfinite().all()) and excess.max().item() <= 0,
                    f"fused_mlp_int8 [{batch * TOKENS}] {act} off its plain "
                    f"version")
            worst["K4"] = max(worst["K4"], err)

    # K8 with nonzero biases: bf16 out at K6's bar, int8 out at K3's; at
    # B=2 and 128, at head width 128, and over 600 tokens (more than the
    # first version's staged head held in shared memory)
    worst["K8"] = worst["K8q"] = 0.0
    for batch, tokens, d in ((2, TOKENS, 88), (BATCH, TOKENS, 88),
                             (2, TOKENS, 128), (2, 600, 88)):
        qkv = attention_inputs(batch, seed=80 + batch + tokens + d,
                               tokens=tokens, hd=heads * d)
        qb, vb = biases(heads * d, seed=81 + d)
        shape = f"[{batch},{tokens},{qkv.shape[-1]}]"
        err = check_close(
            f"K8 fused_attention_qkv {shape} biased",
            fused_attention_qkv(qkv, qb, vb, d ** -0.5, heads),
            fused_attention_qkv_ref(qkv, qb, vb, d ** -0.5, heads))
        errq = check_codes(
            f"K8 fused_attention_qkv quant_out {shape} biased",
            fused_attention_qkv(qkv, qb, vb, d ** -0.5, heads,
                                quant_out=True),
            fused_attention_qkv_ref(qkv, qb, vb, d ** -0.5, heads,
                                    quant_out=True), 0.99, 2 ** -7)
        if d == 88:  # EVA-g's head width, the ladder's
            worst["K8"] = max(worst["K8"], err)
            worst["K8q"] = max(worst["K8q"], errq)

    # K9 at K1's and K3's bars, also padded to 264 tokens with n_real
    qkv = attention_inputs(BATCH, seed=82)
    worst["K9"] = check_close(
        f"K9 fused_attention_qkv2 [{BATCH},{TOKENS},{qkv.shape[-1]}]",
        fused_attention_qkv2(qkv, scale, heads),
        fused_attention_qkv2_ref(qkv, scale, heads))
    worst["K9q"] = 0.0
    for batch, tokens, n_real in ((BATCH, TOKENS, 0), (2, 264, TOKENS)):
        qkv = attention_inputs(batch, seed=83 + batch, tokens=tokens)
        worst["K9q"] = max(worst["K9q"], check_codes(
            f"K9 fused_attention_qkv2 quant_out [{batch},{tokens},"
            f"{qkv.shape[-1]}] n_real={n_real}",
            fused_attention_qkv2(qkv, scale, heads, quant_out=True,
                                 n_real=n_real),
            fused_attention_qkv2_ref(qkv, scale, heads, quant_out=True,
                                     n_real=n_real), 0.99, 2 ** -7))

    worst.update(row_checks()[0])
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
        n = cfg.layers * fw
        want = (expect(K2=2 * n, K3=n, K4=n) if int8 else expect(K1=n))
        require(counts == want, f"{tag} launches {counts}, expected {want}")
        launches.update({k: v for k, v in counts.items() if want[k]})
    cos = min(cosine(feats["int8"][False, v], feats["bf16"][False, v]).min()
              for v in VIDEOS)
    print(f"[main] int8 vs bf16 features (float front end): min cosine "
          f"{cos:.6f}")
    return {"launches": launches, "encoders": encoders, "frames": frames,
            "features": {vid: feats["int8"][False, vid] for vid in VIDEOS}}


def factory_weights(cfg, text_cfg, pretrained: Path) -> dict:
    """One `text.*` / `visual.*` state dict for every factory build: the
    checkpoint when there is one, else one draw of seeded random weights."""
    from hirest_tpu_torch.models.convert import load_torch_ckpt
    from hirest_tpu_torch.utils.init import (random_eva_text_state_dict,
                                             random_eva_vision_state_dict)

    ckpt = pretrained / "eva_clip_psz14.pt"
    if ckpt.exists():
        return load_torch_ckpt(str(ckpt))
    t0 = time.perf_counter()
    sd = {**{f"text.{k}": v for k, v in
             random_eva_text_state_dict(text_cfg, seed=0).items()},
          **{f"visual.{k}": v for k, v in
             random_eva_vision_state_dict(cfg, seed=0).items()}}
    print(f"[factory] seeded random weights drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    return sd


def prompt_ids(n: int, seed: int, text_cfg) -> np.ndarray:
    """Token ids [n, 77] as the tokenizer gives them: tokens below the EOT
    id (the vocabulary's last), EOT at varied positions, zeros after."""
    ctx, eot = text_cfg.context_length, text_cfg.vocab_size - 1
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, eot, size=(n, ctx))
    ends = rng.integers(1, ctx, size=n)
    for row, end in zip(ids, ends):
        row[end] = eot
        row[end + 1:] = 0
    return ids


# factory configuration -> (its options, launches per image forward)
FACTORY = {
    "unrolled": (dict(scan=False), dict(K6=1)),
    "padded_unrolled": (dict(scan=False, padded_heads=True), dict(K7=1)),
    "padded_scanned": (dict(scan=True, padded_heads=True), dict(K1=1)),
    "padded_scanned_int8": (dict(scan=True, padded_heads=True, int8=True),
                            dict(K2=2, K3=1, K4=1)),
}


def phase_factory(cfg, text_cfg, weights: dict) -> dict:
    """build_eva_model_and_transforms at full width on the card: the text
    tower on PROMPTS prompts, and every image configuration of FACTORY on
    FACTORY_FORWARDS forwards of B=128, with the launch counts zeroed
    before each run and read after it."""
    from hirest_tpu_torch.models.eva_clip import build_eva_model_and_transforms

    frames = normalize_frames(np.random.default_rng(2).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8))
    models, feats, launches = {}, {}, {}
    for tag, (options, per_forward) in FACTORY.items():
        t0 = time.perf_counter()
        models[tag] = build_eva_model_and_transforms(
            pretrained=weights, device="cuda", text_config=text_cfg,
            vision_config=cfg, **options)[0]
        torch.cuda.synchronize()
        print(f"[factory] {tag}: built in {time.perf_counter() - t0:.1f} s")
        zero_counts()
        for _ in range(FACTORY_FORWARDS):
            out = models[tag].encode_image(frames)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expect(**{k: v * cfg.layers * FACTORY_FORWARDS
                         for k, v in per_forward.items()})
        print(f"[factory] {tag}: {FACTORY_FORWARDS} forwards of {BATCH} "
              f"frames; launches {counts}")
        require(counts == want, f"{tag} launches {counts}, expected {want}")
        require(tuple(out.shape) == (BATCH, cfg.embed_dim)
                and bool(out.isfinite().all()), f"{tag}: output {out.shape}")
        feats[tag] = out.cpu().numpy()
        launches.update({k: v for k, v in counts.items() if want[k]})
    for tag in ("padded_unrolled", "padded_scanned"):  # same function
        cos = cosine(feats[tag], feats["unrolled"]).min()
        print(f"[factory] {tag} vs unrolled: min cosine {cos:.6f} "
              f"(>= {COS_MIN})")
        require(cos >= COS_MIN, f"{tag} off the unrolled tower")
    cos = cosine(feats["padded_scanned_int8"], feats["padded_scanned"]).min()
    print(f"[factory] padded int8 vs padded bf16: min cosine {cos:.6f} "
          f"(>= {COS_INT8_VS_FLOAT})")
    require(cos >= COS_INT8_VS_FLOAT, "padded int8 off padded bf16")

    ids = prompt_ids(PROMPTS, seed=3, text_cfg=text_cfg)
    zero_counts()
    text = torch.cat([models["unrolled"].encode_text(ids[i: i + BATCH])
                      for i in range(0, PROMPTS, BATCH)])
    torch.cuda.synchronize()
    print(f"[factory] encode_text: {tuple(text.shape)} from {PROMPTS} "
          f"prompts, EOT at positions {int(ids.argmax(1).min())}.."
          f"{int(ids.argmax(1).max())}; launches {read_counts()}")
    require(tuple(text.shape) == (PROMPTS, text_cfg.embed_dim)
            and bool(text.isfinite().all()) and read_counts() == expect(),
            "encode_text output")
    return {"models": models, "frames": frames, "ids": ids,
            "launches": launches}


# ladder configuration -> (flags of build_scanned_vision_apply, launches
# per forward); bench.py's ladder tags (:817-823) less the TPU layout flags
LADDER = {
    "bf16": ({}, dict(K8=1)),
    "bf16+v2": (dict(attn_v2=True), dict(K9=1)),
    "bf16+v3+lnk": (dict(attn_v3=True, fused_ln=True), dict(K1=1, K10=2)),
    "int8": (dict(int8=True), dict(K8=1)),
    "int8+fq": (dict(int8=True, fused_quant=True), dict(K2=2, K5=1, K8q=1)),
    "int8+fq+v2": (dict(int8=True, fused_quant=True, attn_v2=True),
                   dict(K2=2, K5=1, K9q=1)),
    "int8+fq+v3": (dict(int8=True, fused_quant=True, attn_v3=True),
                   dict(K2=2, K3=1, K5=1)),
}
LADDER_FORWARDS = 2  # image forwards of B=128 per ladder configuration


def phase_ladder(cfg, weights: dict) -> dict:
    """Every configuration of LADDER at full width, on one bf16 and one int8
    tower staged once (stage_scanned_params), LADDER_FORWARDS forwards of
    B=128 each with the launch counts zeroed before and read after. Returns
    the forwards, their frames and the launches summed over the runs."""
    from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                                  stage_scanned_params)

    frames = normalize_frames(np.random.default_rng(5).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8))
    staged = {}
    for int8 in (False, True):
        t0 = time.perf_counter()
        staged[int8] = stage_scanned_params(weights, cfg, int8=int8,
                                            device="cuda")
        torch.cuda.synchronize()
        print(f"[ladder] {'int8' if int8 else 'bf16'} tower staged in "
              f"{time.perf_counter() - t0:.1f} s")
    fns, feats, launches = {}, {}, {}
    for tag, (flags, per_forward) in LADDER.items():
        fns[tag] = build_scanned_vision_apply(
            None, cfg, staged=staged[bool(flags.get("int8"))], device="cuda",
            **flags)
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(LADDER_FORWARDS):
            out = fns[tag](frames)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expect(**{k: v * cfg.layers * LADDER_FORWARDS
                         for k, v in per_forward.items()})
        print(f"[ladder] {tag}: {LADDER_FORWARDS} forwards of {BATCH} frames "
              f"in {time.perf_counter() - t0:.2f} s; launches {counts}")
        require(counts == want, f"ladder {tag} launches {counts}, expected "
                                f"{want}")
        require(tuple(out.shape) == (BATCH, cfg.embed_dim)
                and bool(out.isfinite().all()), f"ladder {tag}: output "
                                                f"{tuple(out.shape)}")
        feats[tag] = out.cpu().numpy()
        for k, n in counts.items():
            if n:
                launches[k] = launches.get(k, 0) + n
    for tag, (flags, _) in LADDER.items():
        bar = COS_INT8_VS_FLOAT if flags.get("int8") else COS_MIN
        cos = cosine(feats[tag], feats["bf16"]).min()
        print(f"[ladder] {tag} vs bf16 at full depth: min cosine {cos:.6f} "
              f"(>= {bar})")
        require(cos >= bar, f"ladder {tag} off the bf16 forward")
    return {"fns": fns, "frames": frames, "launches": launches}


def phase_ladder_depth(cfg, frames) -> None:
    """Each LADDER configuration cut to 2 layers, on the card in bf16
    against the plain path on the CPU in f32 with the same flags: cosine
    >= 0.99 (bf16 vs float, int8 vs int8), and int8 >= 0.98 against the
    CPU float forward."""
    from dataclasses import replace

    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    cut = replace(cfg, layers=2)
    sd = random_eva_vision_state_dict(cut, seed=0)
    cpu_float = None
    for tag, (flags, _) in LADDER.items():
        ref = build_scanned_vision_apply(sd, cut, device="cpu",
                                         dtype=torch.float32,
                                         **flags)(frames).numpy()
        got = build_scanned_vision_apply(sd, cut, device="cuda",
                                         **flags)(frames).cpu().numpy()
        cpu_float = ref if cpu_float is None else cpu_float
        checks = [("card vs f32 CPU plain, same flags", ref, COS_MIN)]
        if flags.get("int8"):
            checks.append(("card vs float f32 CPU plain", cpu_float,
                           COS_INT8_VS_FLOAT))
        for what, want, bar in checks:
            cos = cosine(got, want).min()
            print(f"[depth] 2 layers, ladder {tag}, {what}: cosine "
                  f"min={cos:.6f} (>= {bar})")
            require(got.shape == (len(frames), cfg.embed_dim)
                    and bool(cos >= bar), f"2-layer ladder {tag} {what} "
                                          f"below {bar}")


def phase_depth(cfg, pretrained: Path) -> np.ndarray:
    """The same weights at 2 layers: the card's bf16 and int8 forwards
    against the plain path on the CPU in f32. Returns the 4 frames used."""
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
        out = build_scanned_vision_apply(sd, cut, int8=int8, attn_v3=True,
                                         fused_quant=int8, fused_mlp=int8,
                                         device=device, dtype=dtype)(frames)
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
    return frames


def phase_factory_depth(cfg, text_cfg, weights: dict, frames) -> None:
    """The factory's towers cut to 2 layers, on the card in bf16 against the
    unpadded plain paths on the CPU in f32, at cosine >= 0.99: the text
    tower, the unrolled tower, the padded unrolled tower against the
    unrolled one and the padded scanned tower against the scanned one."""
    from dataclasses import replace

    from hirest_tpu_torch.models.eva_clip import build_eva_model_and_transforms

    cuts = dict(text_config=replace(text_cfg, layers=2),
                vision_config=replace(cfg, layers=2))
    ids = prompt_ids(8, seed=4, text_cfg=text_cfg)

    def build(device, **options):
        dtype = torch.bfloat16 if device == "cuda" else torch.float32
        return build_eva_model_and_transforms(
            pretrained=weights, device=device, dtype=dtype, **cuts,
            **options)[0]

    cpu = {scan: build("cpu", scan=scan) for scan in (False, True)}
    ref_text = cpu[False].encode_text(ids).numpy()
    ref_image = {scan: m.encode_image(frames).numpy()
                 for scan, m in cpu.items()}
    for what, options, ref in (
            ("unrolled", dict(scan=False), ref_image[False]),
            ("padded unrolled vs unpadded", dict(scan=False,
                                                 padded_heads=True),
             ref_image[False]),
            ("padded scanned vs unpadded", dict(scan=True,
                                                padded_heads=True),
             ref_image[True])):
        model = build("cuda", **options)
        cos = cosine(model.encode_image(frames).cpu().numpy(), ref)
        print(f"[depth] 2 layers, {what}: bf16 card vs f32 CPU plain: "
              f"cosine min={cos.min():.6f} (>= {COS_MIN})")
        require(bool(cos.min() >= COS_MIN), f"2-layer {what} below {COS_MIN}")
    cos = cosine(model.encode_text(ids).cpu().numpy(), ref_text)
    print(f"[depth] 2 layers, text tower: bf16 card vs f32 CPU plain: "
          f"cosine min={cos.min():.6f} (>= {COS_MIN})")
    require(bool(cos.min() >= COS_MIN), f"2-layer text tower below {COS_MIN}")


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


def time_factory(factory: dict, card: str) -> None:
    """Frames/s of every factory image configuration at B=128 and text
    prompts/s at TEXT_BATCH, host clock around work ending in a
    synchronize, after one warm-up call."""
    for tag, model in factory["models"].items():
        for what, fn, n in (
                ("images", lambda: model.encode_image(factory["frames"]),
                 BATCH),
                ("prompts", lambda: model.encode_text(
                    factory["ids"][:TEXT_BATCH]), TEXT_BATCH)):
            if what == "prompts" and tag != "unrolled":
                continue  # one text tower is enough: they are the same
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iters = 5
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            rate = n * iters / (time.perf_counter() - t0)
            label = ("text encoder" if what == "prompts"
                     else f"factory {tag} encode_image")
            print(f"[timing] {card}: {label} B={n}: {rate:.2f} {what}/s")


def time_ladder(ladder: dict, card: str) -> None:
    """Frames/s of every ladder configuration at B=128, as time_factory."""
    for tag, fn in ladder["fns"].items():
        fn(ladder["frames"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            fn(ladder["frames"])
        torch.cuda.synchronize()
        fps = BATCH * iters / (time.perf_counter() - t0)
        print(f"[timing] {card}: ladder {tag} B={BATCH}: {fps:.2f} frames/s")


def phase_timing(cfg, main: dict, factory: dict, ladder: dict,
                 card: str) -> dict:
    """Frames/s, and each kernel's ms beside its plain version, a library
    yardstick and the bound, at the main path's B=128 shapes."""
    import torch.nn.functional as F

    from hirest_tpu_torch.models.layers import split_heads
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_packed_ref,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv2_ref,
                                                fused_attention_qkv3,
                                                fused_attention_qkv3_ref,
                                                fused_attention_qkv_ref,
                                                fused_attention_ref)
    from hirest_tpu_torch.ops.quant import (_mlp_hidden_launch,
                                            _mlp_out_launch, act_quant,
                                            act_quant_ref, fused_mlp_int8,
                                            fused_mlp_int8_ref, ln_bf16,
                                            ln_bf16_ref, ln_quant,
                                            ln_quant_ref,
                                            mlp_int8_hidden_ref,
                                            mlp_int8_out_ref)

    time_encoders(main, card)
    time_factory(factory, card)
    time_ladder(ladder, card)
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
        **bound(m * w * 2 + m * w + m * 4 + 2 * w * 4,
                ROW_SLOTS["K2"] * m * w, ISSUE_SLOTS_PER_S)}

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
    # K4's two kernels alone, each against its plain version and its one
    # product as torch._int_mm; the bytes count the hidden codes and
    # scales that pass between them
    codes, scales = _mlp_hidden_launch(*args[:5], "gelu_poly")
    code_bytes = m * hid + m * (hid // 1024) * 4
    stages = {
        "K4a mlp_hidden": {
            "ms": cuda_ms(lambda: _mlp_hidden_launch(*args[:5], "gelu_poly"),
                          5),
            "plain_ms": cuda_ms(lambda: mlp_int8_hidden_ref(*args[:5]), 3),
            "library_ms": cuda_ms(lambda: torch._int_mm(h_q, w1_q.t()), 5),
            **bound(m * w + m * 4 + hid * w + 8 * hid + code_bytes,
                    2 * m * w * hid, INT8_OP_PER_S)},
        "K4b mlp_out": {
            "ms": cuda_ms(lambda: _mlp_out_launch(codes, scales, *args[5:]),
                          5),
            "plain_ms": cuda_ms(lambda: mlp_int8_out_ref(codes, scales,
                                                         *args[5:]), 3),
            "library_ms": cuda_ms(lambda: torch._int_mm(codes, w2_q.t()), 5),
            **bound(code_bytes + hid * w + 8 * w + 2 * m * w * 2,
                    2 * m * w * hid, INT8_OP_PER_S)}}
    # the unrolled towers' attention: K6 on split-heads views of one qkv
    # projection, K7 on packed heads at the padded width; K1 and K3 at the
    # padded width (heads padded 88 -> 128) on the padded scanned tower
    qkv = attention_inputs(BATCH, seed=11)
    q, k, v = split_views(qkv)
    res["K6"] = {
        "ms": cuda_ms(lambda: fused_attention(q, k, v, scale), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_ref(q, k, v, scale), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20),
        **bound(4 * q.numel() * 2, attn_flops, BF16_FLOP_PER_S)}
    qkv128 = attention_inputs(BATCH, seed=12, hd=PADDED_HD)
    p128 = 128 ** -0.5
    q, k, v = qkv128.chunk(3, -1)
    qs, ks, vs = (split_heads(t, heads) for t in (q, k, v))
    flops128 = 2 * 2 * BATCH * heads * s * s * 128
    res["K7"] = {
        "ms": cuda_ms(lambda: fused_attention_packed(q, k, v, p128, heads),
                      20),
        "plain_ms": cuda_ms(lambda: fused_attention_packed_ref(
            q, k, v, p128, heads), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=p128), 20),
        **bound(4 * q.numel() * 2, flops128, BF16_FLOP_PER_S)}
    padded = {
        "K1 d=128": {
            "ms": cuda_ms(lambda: fused_attention_qkv3(qkv128, p128, heads),
                          20),
            "plain_ms": cuda_ms(lambda: fused_attention_qkv3_ref(
                qkv128, p128, heads), 5),
            "library_ms": res["K7"]["library_ms"],
            **bound(qkv128.numel() * 2 + m * PADDED_HD * 2, flops128,
                    BF16_FLOP_PER_S)},
        "K3 d=128": {
            "ms": cuda_ms(lambda: fused_attention_qkv3(
                qkv128, p128, heads, quant_out=True), 20),
            "plain_ms": cuda_ms(lambda: fused_attention_qkv3_ref(
                qkv128, p128, heads, quant_out=True), 5),
            "library_ms": None,
            **bound(qkv128.numel() * 2 + m * PADDED_HD + m * 4, flops128,
                    BF16_FLOP_PER_S)}}
    # K9 on K1's and K3's inputs: the same kernel under its own wrapper
    res["K9"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv2(qkv, scale, heads), 20),
        "plain_ms": cuda_ms(
            lambda: fused_attention_qkv2_ref(qkv, scale, heads), 5),
        "library_ms": res["K1"]["library_ms"],
        **bound(qkv.numel() * 2 + m * w * 2, attn_flops, BF16_FLOP_PER_S)}
    res["K9q"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv2(
            qkv, scale, heads, quant_out=True), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv2_ref(
            qkv, scale, heads, quant_out=True), 5),
        "library_ms": None,
        **bound(qkv.numel() * 2 + m * w + m * 4, attn_flops,
                BF16_FLOP_PER_S)}
    # K8 on a qkv projection without bias and nonzero q/v biases; its
    # library yardstick runs on the heads with the biases already added
    qkv8 = attention_inputs(BATCH, seed=13)
    qb, vb = biases(w, seed=14)
    q, k, v = (split_heads(t, heads) for t in qkv8.chunk(3, -1))
    qbh, vbh = (split_heads(t + bias, heads) for t, bias in
                ((qkv8[..., :w], qb), (qkv8[..., 2 * w:], vb)))
    res["K8"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv(qkv8, qb, vb, scale,
                                                  heads), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv_ref(
            qkv8, qb, vb, scale, heads), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qbh, k, vbh, scale=scale), 20),
        **bound(qkv8.numel() * 2 + 2 * w * 2 + m * w * 2, attn_flops,
                BF16_FLOP_PER_S)}
    res["K8q"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv(qkv8, qb, vb, scale, heads,
                                                  quant_out=True), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv_ref(
            qkv8, qb, vb, scale, heads, quant_out=True), 5),
        "library_ms": None,
        **bound(qkv8.numel() * 2 + 2 * w * 2 + m * w + m * 4, attn_flops,
                BF16_FLOP_PER_S)}
    # K5 on the int8 MLP's fc1 output with gelu_bf16_poly, and on an
    # attention output without activation
    h6 = fc1_inputs(m, seed=15, c=hid)
    res["K5"] = {
        "ms": cuda_ms(lambda: act_quant(h6, act="gelu_poly"), 20),
        "plain_ms": cuda_ms(lambda: act_quant_ref(h6, act="gelu_poly"), 5),
        "library_ms": None,
        **bound(m * hid * 3 + m * 4, ROW_SLOTS["K5 gelu_poly"] * m * hid,
                ISSUE_SLOTS_PER_S)}
    h1 = fc1_inputs(m, seed=16, c=w)
    extra = {"K5 act=none [M,1408]": {
        "ms": cuda_ms(lambda: act_quant(h1), 20),
        "plain_ms": cuda_ms(lambda: act_quant_ref(h1), 5),
        "library_ms": None,
        **bound(m * w * 3 + m * 4, ROW_SLOTS["K5 none"] * m * w,
                ISSUE_SLOTS_PER_S)}}
    # K10 against F.layer_norm on the same bf16 rows
    x10, g10, b10 = ln_inputs(m, seed=17)
    res["K10"] = {
        "ms": cuda_ms(lambda: ln_bf16(x10, g10, b10, EPS), 20),
        "plain_ms": cuda_ms(lambda: ln_bf16_ref(x10, g10, b10, EPS), 5),
        "library_ms": cuda_ms(lambda: F.layer_norm(
            x10, (w,), g10.bfloat16(), b10.bfloat16(), EPS), 20),
        **bound(m * w * 2 * 2 + 2 * w * 4, ROW_SLOTS["K10"] * m * w,
                ISSUE_SLOTS_PER_S)}
    for name, r in {**res, **stages, **padded, **extra}.items():
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
        ("K2 ln_quant (CUDA)", ("ln_quant", "ln_kernel")),
        ("K3 attention_qkv3 int8 epilogue (CUDA, both steps)",
         ("attention_qkv3", "quant_rows")),
        ("K4 fused_mlp_int8 (CUDA)", ("fused_mlp_int8",)),
        ("int8 qkv/out GEMMs (torch._int_mm)",
         ("nvjet", "gemm", "cutlass", "xmma", "imma")),
        ("elementwise (int8_mm dequant epilogue, residual, casts)",
         ("elementwise", "reduce")),
    ),
    "ladder bf16": (
        ("K8 attention_split (CUDA)", ("attention_split",)),
        ("projections (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
        ("layer_norm", ("layer_norm",)),
        ("elementwise (GELU chain, casts, residual)",
         ("elementwise", "reduce")),
    ),
    "ladder int8 K8": (
        ("K2 ln_quant (CUDA)", ("ln_quant", "ln_kernel")),
        ("K8 attention_split, with int8 out both steps (CUDA)",
         ("attention_split", "quant_rows")),
        ("K5 act_quant (CUDA)", ("act_quant",)),
        ("int8 GEMMs (torch._int_mm)",
         ("nvjet", "gemm", "cutlass", "xmma", "imma")),
        ("elementwise (dequant epilogues, row quantization, GELU chain, "
         "residual, casts)", ("elementwise", "reduce")),
    ),
    "ladder int8": (
        ("K2 ln_quant (CUDA)", ("ln_quant", "ln_kernel")),
        ("K3 attention_qkv3 int8 epilogue (CUDA, both steps)",
         ("attention_qkv3", "quant_rows")),
        ("K5 act_quant (CUDA)", ("act_quant",)),
        ("int8 GEMMs (torch._int_mm)",
         ("nvjet", "gemm", "cutlass", "xmma", "imma")),
        ("elementwise (int8_mm dequant epilogues, residual, casts)",
         ("elementwise", "reduce")),
    ),
    "serving": (
        ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "gemv")),
        ("softmax and log_softmax", ("softmax",)),
        ("top-k and sort (beam)", ("topk", "sort", "radix", "bitonic")),
        ("reductions (LayerNorm statistics, norms, argmax)", ("reduce",)),
        ("gathers, index copies, cat", ("index", "gather", "scatter",
                                        "Cat", "copy")),
        ("elementwise", ("elementwise",)),
    ),
    "unrolled": (
        ("K6/K7 attention_split (CUDA)", ("attention_split",)),
        ("projections (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
        ("exact GELU", ("gelu", "Gelu")),
        ("elementwise and reductions (LayerNorm, q/v bias, residual, casts)",
         ("elementwise", "reduce")),
    ),
}


def profile_call(label: str, fn, card: str, group_set: str,
                 tag: str = "profile") -> dict:
    """One call's device kernels by group from torch.profiler, and the
    device's idle share of its wall time, after one unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    kernels: dict = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        launches += e.count
        group = next((g for g, keys in KERNEL_GROUPS[group_set]
                      if any(k in e.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        kernels[e.key] = kernels.get(e.key, 0.0) + ms
    busy = sum(groups.values())
    print(f"[{tag}] {card}: {label}: wall {wall_ms:.2f} ms (profiled), "
          f"device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.4f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {g}: {ms:.2f} ms ({ms / busy:.4f} of busy)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]     kernel {name[:110]}: {ms:.2f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy, "launches": launches}


def profile_forward(tag: str, enc, batch: np.ndarray, card: str,
                    group_set: str) -> None:
    """One forward's device kernels by group, and the idle share."""
    profile_call(f"one {tag} forward B={BATCH}", lambda: enc(batch), card,
                 group_set)


def phase_profile(cfg, main: dict, factory: dict, ladder: dict,
                  card: str) -> None:
    """Where one float-front-end forward's time goes, for each precision and
    for the factory's bf16 image configurations, and each plain per-layer
    op timed alone at the main path's shapes with CUDA events."""
    import torch.nn.functional as F

    from hirest_tpu_torch.models.eva_clip import layer_norm
    from hirest_tpu_torch.models.layers import (gelu, gelu_bf16_poly,
                                                layer_norm_fast_var)
    from hirest_tpu_torch.ops.quant import int8_mm

    batch = normalize_frames(main["frames"]["vid_a"][:BATCH])
    for tag, encoders in main["encoders"].items():
        profile_forward(tag, encoders[False], batch, card, tag)
    for tag, groups in (("bf16", "ladder bf16"), ("int8", "ladder int8 K8"),
                        ("int8+fq", "ladder int8 K8"),
                        ("int8+fq+v3", "ladder int8")):
        profile_forward(f"ladder {tag}", ladder["fns"][tag], batch, card,
                        groups)
    for tag in ("unrolled", "padded_unrolled", "padded_scanned"):
        profile_forward(f"factory {tag}", factory["models"][tag].encode_image,
                        batch, card, "bf16" if "scanned" in tag
                        else "unrolled")

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
        "exact gelu [M,6144]": lambda: gelu(h),
        "layer_norm_fast_var (flax arithmetic) [M,1408]":
            lambda: layer_norm_fast_var(x, norm),
    }
    for name, fn in ops.items():
        print(f"[profile] {card}: {name}, M={m}: "
              f"{cuda_ms(fn, 10):.4f} ms per call")


# the serving phase: prompts, rounds, the bar
SERVE_PROMPTS = ("make oatmeal pancake mix", "fold a fitted sheet",
                 "replace a bike inner tube")
# timed rounds: each prompt retrieved, each video analyzed in each mode
SERVE_ROUNDS = 20
SPLIT_ROUNDS = 5  # analyze requests a video and mode for the split
SERVE_TOL = 1e-5  # card vs CPU f32, cached vs full: of the largest |value|
MODES = {False: "host segmentation loop", True: "fused_segmentation"}


def percentiles(ms: list) -> str:
    return (f"p50 {np.percentile(ms, 50):.2f} ms, p95 "
            f"{np.percentile(ms, 95):.2f} ms over {len(ms)} requests")


def analysis_ok(res: dict, duration: float) -> None:
    lo, hi = res["moment_bounds"]
    require(0 <= lo <= hi <= duration,
            f"{res['video']}: moment bounds {res['moment_bounds']}")
    starts = [st["bounds"][0] for st in res["steps"]]
    require(starts == sorted(starts) and all(
        0 <= st["bounds"][0] <= st["bounds"][1] <= duration
        for st in res["steps"]), f"{res['video']}: steps {res['steps']}")


def timed_requests(engine, card: str) -> None:
    """p50/p95 of retrieve and analyze, host clock around each request,
    whose answer comes back to the host (so its device work has ended).
    SERVE_ROUNDS rounds, each retrieving every prompt and analyzing every
    video in both segmentation modes, one after the other, so the modes
    see the same host; analyze pooled and per video."""
    ret = []
    ana = {(fused, vid): [] for fused in MODES for vid in VIDEOS}
    try:
        for _ in range(SERVE_ROUNDS):
            for prompt in SERVE_PROMPTS:
                t0 = time.perf_counter()
                engine.retrieve(prompt, top_k=3)
                ret.append((time.perf_counter() - t0) * 1e3)
            for vid, (_, duration) in VIDEOS.items():
                for fused in MODES:
                    engine.config.fused_segmentation = fused
                    t0 = time.perf_counter()
                    engine.analyze(SERVE_PROMPTS[0], f"{vid}.mp4", duration)
                    ana[fused, vid].append((time.perf_counter() - t0) * 1e3)
    finally:
        engine.config.fused_segmentation = False
    print(f"[serving] {card}: retrieve {percentiles(ret)}")
    for fused, mode in MODES.items():
        pooled = [ms for vid in VIDEOS for ms in ana[fused, vid]]
        print(f"[serving] {card}: analyze ({mode}) pooled "
              f"{percentiles(pooled)}")
        for vid, (frames, duration) in VIDEOS.items():
            print(f"[serving] {card}: analyze ({mode}) {vid} ({frames} "
                  f"frames) {percentiles(ana[fused, vid])}")


def analyze_split(engine, card: str, fused: bool) -> None:
    """Where an analyze request's wall time goes, SPLIT_ROUNDS requests a
    video: each trainer step timed with a synchronize on either side, the
    rest host work (annotations, collate, feature loads, the segmentation
    walk's bookkeeping); means per video and pooled."""
    trainer = engine.trainer
    spans: dict = {}
    now = {}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans.setdefault((now["vid"], name), []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return call

    steps = {"text encode": "text_encoder_fn",
             "moment retrieval": "_predict_moment_retrieval",
             "segmentation iterations": "_predict_moment_segmentation",
             "beam decode (caption_encode + 48 steps)":
                 "_predict_step_captioning"}
    saved = {attr: trainer.__dict__.get(attr) for attr in steps.values()}
    for name, attr in steps.items():
        setattr(trainer, attr, timed(name, getattr(trainer, attr)))
    total = {vid: [] for vid in VIDEOS}
    engine.config.fused_segmentation = fused
    try:
        for _ in range(SPLIT_ROUNDS):
            for vid, (_, duration) in VIDEOS.items():
                now["vid"] = vid
                t0 = time.perf_counter()
                engine.analyze(SERVE_PROMPTS[0], f"{vid}.mp4", duration)
                total[vid].append((time.perf_counter() - t0) * 1e3)
    finally:  # the instance's own attribute back, or the class's method
        engine.config.fused_segmentation = False
        for attr, fn in saved.items():
            if fn is None:
                delattr(trainer, attr)
            else:
                setattr(trainer, attr, fn)
    for label, vids in [(vid, (vid,)) for vid in VIDEOS] + [
            ("pooled", tuple(VIDEOS))]:
        n = sum(len(total[v]) for v in vids)
        parts = {name: sum(sum(spans.get((v, name), ())) for v in vids) / n
                 for name in steps}
        wall = sum(sum(total[v]) for v in vids) / n
        parts["host rest"] = wall - sum(parts.values())
        print(f"[serving] {card}: analyze split ({MODES[fused]}, {label}), "
              f"mean of {n} requests, {wall:.2f} ms: " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in parts.items()))


def serving_engine(feat_dir: Path, device: str):
    """The engine as `python -m hirest_tpu_torch.serve` builds it, at full
    width: the EVA-CLIP-g text tower (12 x 768) and MomentModel at
    JointModelConfig() with seeded random weights, 5 beams of 48 words,
    HirestConfig's defaults otherwise (f32)."""
    from hirest_tpu_torch.serve.__main__ import build_engine, parse_args

    engine = build_engine(parse_args([
        "--video_feature_dir", str(feat_dir), "--num_beams", "5",
        "--pretrained_dir", str(feat_dir / "none"), "--device", device]))
    return engine


def traced_select(trace: list, on_step=None):
    """A stand-in for infer/beam.py's `_select` that records each step
    (host copies: the prefixes [B, k, t + 1] and scores [B, k] it was
    given, the chosen source slots and tokens [B, k], and the least gap
    between neighbours among each instance's k + 1 best candidates [B],
    with their largest magnitude) and calls on_step(seqs, logits, t)
    first. Returns (the stand-in, the function it stands in for)."""
    from hirest_tpu_torch.infer import beam

    select = beam._select

    def probe(seqs, scores, logits, t):
        if on_step is not None:
            on_step(seqs, logits, t)
        b, k, _ = seqs.shape
        cand = (scores[:, :, None] + torch.log_softmax(
            logits.float(), dim=-1).reshape(b, k, -1)).reshape(b, -1)
        top = cand.topk(k + 1, dim=1).values
        out = select(seqs, scores, logits, t)
        trace.append({
            "seqs": seqs[:, :, :t + 1].cpu().numpy(),
            "scores": scores.cpu().numpy(),
            "src": out[2].cpu().numpy(),
            "tok": out[0][:, :, t + 1].cpu().numpy(),
            "gap": (top[:, :-1] - top[:, 1:]).min(1).values.cpu().numpy(),
            "top": top[:, 0].abs().max().item()})
        return out

    return probe, select


def served_captioning(engine, prompt: str, vid: str, on_step=None) -> tuple:
    """One analyze request as the engine serves it, with the batch that
    reached `Trainer._predict_step_captioning` kept and its beam's steps
    traced (traced_select; on_step(arrs, seqs, logits, t)). Returns (the
    answer, the batch or None, the trace)."""
    from hirest_tpu_torch.infer import beam

    tr, seen, trace = engine.trainer, {}, []
    predict = tr._predict_step_captioning

    def predict_probe(arrs):
        seen["arrs"] = arrs
        return predict(arrs)

    probe, select = traced_select(trace, None if on_step is None else (
        lambda seqs, logits, t: on_step(seen["arrs"], seqs, logits, t)))
    tr._predict_step_captioning, beam._select = predict_probe, probe
    try:
        res = engine.analyze(prompt, f"{vid}.mp4", VIDEOS[vid][1])
    finally:
        del tr._predict_step_captioning
        beam._select = select
    return res, seen.get("arrs"), trace


def held(tag: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| over the largest |want|, required within SERVE_TOL."""
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    top = want.float().abs().max().item()
    print(f"[serving] {tag}: max err {err:.3e}, {err / top:.3e} of max "
          f"|value| {top:.4f}")
    require(err <= SERVE_TOL * top, f"{tag} beyond {SERVE_TOL}")
    return err


def same_selections(tag: str, got: tuple, want: tuple, err: float) -> None:
    """Two runs of one beam (captions, trace) make the same choice at every
    step, unless the step's inputs were equal and want's least gap among
    the k + 1 best candidates of the instance lies within what the two
    runs' differences can move: 2 d + 8 err + 2 ulp, d the largest score
    difference it was given, err the largest logit difference measured on
    equal inputs (doubled for each run's own caches), ulp the candidates'
    rounding. An instance whose choice was excused so is not checked
    further; every other one must end on the same caption."""
    (got_caps, got_tr), (want_caps, want_tr) = got, want
    require(len(got_tr) == len(want_tr), f"{tag}: step counts differ")
    excused = {}
    for t, (g, w) in enumerate(zip(got_tr, want_tr)):
        ulp = float(np.spacing(np.float32(max(g["top"], w["top"]))))
        for i in range(len(w["gap"])):
            if i in excused:
                continue
            require((g["seqs"][i] == w["seqs"][i]).all(),
                    f"{tag}: instance {i} reached step {t} on other prefixes")
            if ((g["src"][i] == w["src"][i]).all()
                    and (g["tok"][i] == w["tok"][i]).all()):
                continue
            d = float(np.abs(g["scores"][i] - w["scores"][i]).max())
            slack = 2 * d + 8 * err + 2 * ulp
            print(f"[serving] {tag} instance {i}: choice differs at step "
                  f"{t}, least gap {w['gap'][i]:.3e}, slack {slack:.3e}")
            require(w["gap"][i] <= slack,
                    f"{tag}: instance {i} chose otherwise at step {t}")
            excused[i] = t
    for i, (g, w) in enumerate(zip(got_caps, want_caps)):
        require(i in excused or g == w, f"{tag}: caption {i} differs")
    gaps = np.concatenate([w["gap"] for w in want_tr])
    print(f"[serving] {tag}: {sum(g == w for g, w in zip(got_caps, want_caps))}"
          f" of {len(want_caps)} captions equal; the same choice at every "
          f"step of {len(want_caps) - len(excused)} instances; least gaps "
          f"{np.sort(gaps)[:3]}, median {np.median(gaps):.3e}")


def moment_logits(engine, prompt: str, name: str, duration: float,
                  bounds: list) -> dict:
    """The moment-retrieval and first segmentation iteration's logits of
    one request's batches."""
    from hirest_tpu_torch.data.annotations import build_examples
    from hirest_tpu_torch.data.batching import collate

    tr = engine.trainer
    anns = {prompt: {name: {"relevant": True, "clip": True,
                            "v_duration": duration, "bounds": bounds,
                            "steps": []}}}
    out = {}
    for task in ("moment_retrieval", "moment_segmentation"):
        batch = collate(build_examples(anns, task, -1, end_to_end=True),
                        tr.store, tr.buckets)
        arrs = tr._prepare(batch, task)
        with torch.inference_mode():
            if task == "moment_retrieval":
                res = tr.model.moment_retrieval(
                    arrs["vis_feats"], arrs["text_feat"],
                    arrs["video_mask"], arrs["moment_mask"])
                out[task] = torch.cat([res["start_logits"],
                                       res["end_logits"]])
            else:
                out[task] = tr.model.moment_segmentation(
                    arrs["vis_feats"], arrs["text_feat"], arrs["video_mask"],
                    arrs["moment_mask"], None, arrs["video_mask"] * 0)
    return out


def compare_card_cpu(engine, cpu_engine) -> None:
    """One analyze request a video and prompt (SERVE_PROMPTS[1:]) on the
    card against the port's CPU f32 engine, each within SERVE_TOL of the
    CPU value's largest magnitude: the moment-retrieval and first
    segmentation logits; the served step-captioning batch's caption_encode
    (the CPU's batch on both); and every decode_step of the CPU's served
    beam, replayed on the card from the CPU's inputs (tokens, cross keys
    and values, caches). Bounds equal; the two served beams' choices held
    by same_selections. On the card the served (cached) beam is also held
    against the full re-decode beam: the full decoder's logits at each
    served step's prefixes within SERVE_TOL of the cached ones, and the
    choices by same_selections."""
    from hirest_tpu_torch.infer import beam

    tr, cpu_tr = engine.trainer, cpu_engine.trainer
    dec, cpu_dec = tr.model.decoder, cpu_tr.model.decoder
    k, words = tr.config.num_beams, tr.config.max_words
    require(tr.tokenizer is None, "captions are ids without a vocabulary")

    def to_card(x):
        if isinstance(x, torch.Tensor):
            return x.to(tr.device)
        return tuple(to_card(y) for y in x)

    def ids_text(row) -> str:  # the trainer's captions without a vocabulary
        return " ".join(str(int(x)) for x in row if x != 0)

    for prompt in SERVE_PROMPTS[1:]:
        for vid, (_, duration) in VIDEOS.items():
            name, tag = f"{vid}.mp4", f"{vid} {prompt!r}"
            err = {"card": 0.0, "full": 0.0}
            state = {}

            def full_vs_cached(arrs, seqs, logits, t):
                if "enc" not in state:
                    state["enc"] = tr.model.caption_encode(
                        arrs["vis_feats"], arrs["text_feat"],
                        arrs.get("asr_feats")).repeat_interleave(k, dim=0)
                b = seqs.shape[0]
                full = dec(seqs.reshape(b * k, -1)[:, :words],
                           state["enc"])[:, t]
                e = (full - logits).abs().max().item()
                err["full"] = max(err["full"], e)
                state["top"] = max(state.get("top", 0.0),
                                   logits.abs().max().item())

            got, arrs, got_tr = served_captioning(engine, prompt, vid,
                                                  full_vs_cached)
            analysis_ok(got, duration)
            cpu_step = cpu_dec.decode_step
            tops = []

            def replay(last, t, cross, cache):
                card_in = (last.to(tr.device), t, to_card(cross),
                           to_card(cache))
                logits, cache = cpu_step(last, t, cross, cache)
                with torch.inference_mode():
                    on_card = dec.decode_step(*card_in)[0].cpu()
                err["card"] = max(err["card"],
                                  (on_card - logits).abs().max().item())
                tops.append(logits.abs().max().item())
                return logits, cache

            cpu_dec.decode_step = replay
            try:
                want, cpu_arrs, want_tr = served_captioning(cpu_engine,
                                                            prompt, vid)
            finally:
                del cpu_dec.decode_step
            require(got["moment_bounds"] == want["moment_bounds"]
                    and [s["bounds"] for s in got["steps"]]
                    == [s["bounds"] for s in want["steps"]],
                    f"{tag}: bounds differ card {got} CPU {want}")
            card_logits = moment_logits(engine, prompt, name, duration,
                                        want["moment_bounds"])
            for task, logits in moment_logits(cpu_engine, prompt, name,
                                              duration,
                                              want["moment_bounds"]).items():
                held(f"{tag} {task} logits card vs CPU f32",
                     card_logits[task], logits)
            print(f"[serving] {tag}: card and CPU agree on bounds "
                  f"{got['moment_bounds']} and {len(got['steps'])} steps")
            if arrs is None:
                continue
            with torch.inference_mode():
                held(f"{tag} caption_encode card vs CPU f32",
                     tr.model.caption_encode(
                         *to_card((cpu_arrs["vis_feats"],
                                   cpu_arrs["text_feat"]))),
                     cpu_tr.model.caption_encode(cpu_arrs["vis_feats"],
                                                 cpu_arrs["text_feat"]))
            top = max(tops)
            print(f"[serving] {tag} decode_step card vs CPU f32 on the CPU "
                  f"beam's {len(tops)} steps: max err {err['card']:.3e}, "
                  f"{err['card'] / top:.3e} of max |logit| {top:.4f}")
            require(err["card"] <= SERVE_TOL * top,
                    f"{tag}: decode_step beyond {SERVE_TOL}")
            captions = [s["caption"] for s in got["steps"]]
            same_selections(f"{tag} card vs CPU beam", (captions, got_tr),
                            ([s["caption"] for s in want["steps"]],
                             want_tr), err["card"])

            print(f"[serving] {tag} full re-decode vs cached logits at the "
                  f"served beam's prefixes: max err {err['full']:.3e}, "
                  f"{err['full'] / state['top']:.3e} of max |logit| "
                  f"{state['top']:.4f}")
            require(err["full"] <= SERVE_TOL * state["top"],
                    f"{tag}: cached decode beyond {SERVE_TOL}")
            b, full_tr = len(got["steps"]), []
            probe, select = traced_select(full_tr)
            beam._select = probe
            try:
                with torch.inference_mode():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    full, _ = beam.beam_search(
                        lambda ids, t: dec(ids[:, :words],
                                           state["enc"])[:, t],
                        b, k, words, tr.bos_id, tr.eos_id, device=tr.device)
                    full = [ids_text(row) for row in full.cpu().numpy()]
                    ms = (time.perf_counter() - t0) * 1e3
            finally:
                beam._select = select
            same_selections(f"{tag} cached vs full beam", (captions, got_tr),
                            (full, full_tr), err["full"])
            print(f"[serving] {tag}: full re-decode beam (traced) on {b} "
                  f"captions x {k} beams x {words} words in {ms:.2f} ms")


def http_requests(engine, direct: dict) -> None:
    """Every request again through the HTTP server on 127.0.0.1, port 0:
    /health, /v1/retrieve and /v1/analyze give what the engine gave."""
    import threading
    import urllib.request

    from hirest_tpu_torch.serve import make_server

    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        print(f"[serving] http /health: {health}")
        require(health["indexed_videos"] == len(VIDEOS)
                and "cuda" in health["devices"][0], "health")
        for prompt in SERVE_PROMPTS:
            got = post("/v1/retrieve", {"prompt": prompt, "top_k": 3})
            require(got == json.loads(json.dumps(direct["retrieve", prompt])),
                    f"http retrieve {prompt!r}")
        for vid, (_, duration) in VIDEOS.items():
            got = post("/v1/analyze", {"prompt": SERVE_PROMPTS[0],
                                       "video": f"{vid}.mp4",
                                       "video_duration": duration})
            require(got == json.loads(json.dumps(direct["analyze", vid])),
                    f"http analyze {vid}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print(f"[serving] http: {len(SERVE_PROMPTS)} retrieve and "
          f"{len(VIDEOS)} analyze requests through {url} gave the engine's "
          f"answers")


def phase_serving(main: dict, card: str) -> None:
    """The serving path at full width over phase_main's int8 features."""
    import tempfile

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        feat_dir = Path(tmp)
        for vid, feats in main["features"].items():
            np.save(feat_dir / f"{vid}.mp4.npy", feats)
        t0 = time.perf_counter()
        engine = serving_engine(feat_dir, "cuda")
        torch.cuda.synchronize()
        zero_counts()  # read at the end: no request launches a kernel
        print(f"[serving] engine on {engine.health()['devices'][0]} built in "
              f"{time.perf_counter() - t0:.1f} s; warmup {engine.warmup()}")
        direct = {}
        for prompt in SERVE_PROMPTS:
            direct["retrieve", prompt] = engine.retrieve(prompt, top_k=3)
            print(f"[serving] retrieve {prompt!r}: "
                  f"{direct['retrieve', prompt]}")
        for vid, (_, duration) in VIDEOS.items():
            res = engine.analyze(SERVE_PROMPTS[0], f"{vid}.mp4", duration)
            analysis_ok(res, duration)
            direct["analyze", vid] = res
            first = res["steps"][0] if res["steps"] else {"caption": ""}
            print(f"[serving] analyze {vid} ({duration} s): moment "
                  f"{res['moment_bounds']}, steps "
                  f"{[st['bounds'] for st in res['steps']]}, first caption "
                  f"{first['caption'][:60]!r}")
        http_requests(engine, direct)
        engine.config.fused_segmentation = True
        for vid, (_, duration) in VIDEOS.items():
            res = engine.analyze(SERVE_PROMPTS[0], f"{vid}.mp4", duration)
            analysis_ok(res, duration)
            print(f"[serving] fused_segmentation analyze {vid}: steps "
                  f"{[st['bounds'] for st in res['steps']]}; host loop's "
                  f"{[st['bounds'] for st in direct['analyze', vid]['steps']]}")
        engine.config.fused_segmentation = False
        t0 = time.perf_counter()
        timed_requests(engine, card)
        print(f"[serving] timed requests took "
              f"{time.perf_counter() - t0:.1f} s")
        for fused, mode in MODES.items():
            analyze_split(engine, card, fused)
            engine.config.fused_segmentation = fused
            try:
                profile_call(f"one analyze request (vid_a, {mode})",
                             lambda: engine.analyze(
                                 SERVE_PROMPTS[0], "vid_a.mp4",
                                 VIDEOS["vid_a"][1]), card, "serving",
                             tag="serving")
            finally:
                engine.config.fused_segmentation = False
        t0 = time.perf_counter()
        cpu_engine = serving_engine(feat_dir, "cpu")
        print(f"[serving] CPU f32 engine built in "
              f"{time.perf_counter() - t0:.1f} s")
        compare_card_cpu(engine, cpu_engine)
        print(f"[serving] checks against the CPU and the full beam took "
              f"{time.perf_counter() - t0:.1f} s")
        counts = read_counts()
        print(f"[serving] kernel launches during every request and check "
              f"above: {counts}")
        require(counts == expect(), "the serving path launched a kernel")
    print(f"[serving] phase done in {time.perf_counter() - start:.1f} s")


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
    "K6": ("fused_attention", "hirest_tpu_torch/ops/csrc/attention_split.cu",
           "hirest_tpu/ops/attention.py:69"),
    "K7": ("fused_attention_packed",
           "hirest_tpu_torch/ops/csrc/attention_split.cu",
           "hirest_tpu/ops/attention.py:188"),
    "K5": ("act_quant", "hirest_tpu_torch/ops/csrc/act_quant.cu",
           "hirest_tpu/ops/quant.py:176"),
    "K8": ("fused_attention_qkv",
           "hirest_tpu_torch/ops/csrc/attention_split.cu",
           "hirest_tpu/ops/attention.py:551"),
    "K8q": ("fused_attention_qkv(quant_out=True)",
            "hirest_tpu_torch/ops/csrc/attention_split.cu",
            "hirest_tpu/ops/attention.py:585"),
    "K9": ("fused_attention_qkv2",
           "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:349"),
    "K9q": ("fused_attention_qkv2(quant_out=True)",
            "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
            "hirest_tpu/ops/attention.py:378"),
    "K10": ("ln_bf16", "hirest_tpu_torch/ops/csrc/ln_quant.cu",
            "hirest_tpu/ops/quant.py:220"),
}


ARITH_VARIANTS = {  # attention_split.cu's HIREST_SPLIT_ARITH -> its softmax
    0: "ex2.approx.ftz, reciprocal (shipped)", 4: "exp2f, reciprocal",
    1: "expf, reciprocal", 2: "ex2.approx.ftz, __fdiv_rn",
    3: "expf, __fdiv_rn"}


def time_attention(cfg, card: str) -> None:
    """K1 and K3 (at head widths 88 and 128), K9 (bf16 and int8 out), K6,
    K7 and K8 (bf16 and int8 out) ms per call at B=128, beside
    scaled_dot_product_attention at each head width, and nothing else,
    through the wrappers that earlier versions of the port have too, so
    that this file copied into an earlier checkout times that checkout's
    kernels. K1 is also timed at 192 and 384 tokens (whole 192-row query
    tiles: every consumer of attention_qkv3.cu busy), against 257, where a
    head's second tile has 65 rows. Where the checkout's attention_split.cu
    has arithmetic variants, K6 and K7 are timed again under each, and each
    held against its plain version at K6's bar."""
    import inspect
    from concurrent.futures import ThreadPoolExecutor

    import torch.nn.functional as F

    from hirest_tpu_torch.ops import attention, build
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_packed_ref,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv3,
                                                fused_attention_ref)

    variants = "defines" in inspect.signature(build.load).parameters
    flags = {k: (f"-DHIREST_SPLIT_ARITH={k}",) for k in ARITH_VARIANTS if k}
    with ThreadPoolExecutor(8) as pool:
        jobs = [pool.submit(build.build,
                            ("attention_qkv3", "attention_split"))]
        if variants:
            jobs += [pool.submit(build.build, ("attention_split",), f)
                     for f in flags.values()]
        for job in jobs:
            job.result()
    scale, heads = cfg.head_width ** -0.5, cfg.num_heads
    p128 = 128 ** -0.5
    qkv = attention_inputs(BATCH, seed=7)
    q, k, v = split_views(attention_inputs(BATCH, seed=11))
    qkv128 = attention_inputs(BATCH, seed=12, hd=PADDED_HD)
    pq, pk, pv = qkv128.chunk(3, -1)
    qkv8 = attention_inputs(BATCH, seed=13)
    qb, vb = biases(heads * cfg.head_width, seed=14)
    hq, hk, hv = split_views(qkv)
    sq, sk, sv = split_views(qkv128)
    qkv192 = attention_inputs(BATCH, seed=15, tokens=192)
    qkv384 = attention_inputs(BATCH, seed=16, tokens=384)
    ms = {"K1": cuda_ms(lambda: fused_attention_qkv3(qkv, scale, heads), 50),
          "K1 S=192": cuda_ms(lambda: fused_attention_qkv3(
              qkv192, scale, heads), 50),
          "K1 S=384": cuda_ms(lambda: fused_attention_qkv3(
              qkv384, scale, heads), 50),
          "K1 d=128": cuda_ms(lambda: fused_attention_qkv3(
              qkv128, p128, heads), 50),
          "K3": cuda_ms(lambda: fused_attention_qkv3(
              qkv, scale, heads, quant_out=True), 50),
          "K3 d=128": cuda_ms(lambda: fused_attention_qkv3(
              qkv128, p128, heads, quant_out=True), 50),
          "K9": cuda_ms(lambda: fused_attention_qkv2(qkv, scale, heads), 50),
          "K9q": cuda_ms(lambda: fused_attention_qkv2(
              qkv, scale, heads, quant_out=True), 50),
          "SDPA d=88": cuda_ms(lambda: F.scaled_dot_product_attention(
              hq, hk, hv, scale=scale), 50),
          "SDPA d=128": cuda_ms(lambda: F.scaled_dot_product_attention(
              sq, sk, sv, scale=p128), 50),
          "K6": cuda_ms(lambda: fused_attention(q, k, v, scale), 50),
          "K7": cuda_ms(lambda: fused_attention_packed(
              pq, pk, pv, p128, heads), 50),
          "K8": cuda_ms(lambda: fused_attention_qkv(qkv8, qb, vb, scale,
                                                    heads), 50),
          "K8q": cuda_ms(lambda: fused_attention_qkv(
              qkv8, qb, vb, scale, heads, quant_out=True), 50)}
    print(f"[time-attention] {card}: {REPO}: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in ms.items()))
    if not variants:
        return
    want6 = fused_attention_ref(q, k, v, scale)
    want7 = fused_attention_packed_ref(pq, pk, pv, p128, heads)
    shipped = attention._split_lib
    try:
        for k_arith, name in [*ARITH_VARIANTS.items(), (0, ARITH_VARIANTS[0])]:
            defines = flags.get(k_arith, ())
            attention._split_lib = lambda: shipped(defines)
            err6 = check_close(f"K6 {name}", fused_attention(q, k, v, scale),
                               want6)
            err7 = check_close(f"K7 {name}", fused_attention_packed(
                pq, pk, pv, p128, heads), want7)
            t6 = cuda_ms(lambda: fused_attention(q, k, v, scale), 50)
            t7 = cuda_ms(lambda: fused_attention_packed(pq, pk, pv, p128,
                                                        heads), 50)
            print(f"[time-attention] {card}: softmax {name}: K6 {t6:.4f} ms "
                  f"(max_abs_err {err6}), K7 {t7:.4f} ms (max_abs_err "
                  f"{err7})")
    finally:
        attention._split_lib = shipped


def time_mlp(card: str) -> None:
    """K4 ms per call at B=128 beside its two products as torch._int_mm,
    and nothing else, through the wrapper that earlier versions of the
    port have too (see time_attention). Where the checkout splits K4 into
    two kernels, the first is also timed alone."""
    from hirest_tpu_torch.ops import build, quant

    build.build(("fused_mlp_int8",))
    m = BATCH * TOKENS
    args = mlp_inputs(m, seed=9)
    h_q, _, w1_q, _, _, w2_q, _, _, _ = args
    hidden_q = torch.randint(-127, 128, (m, w1_q.shape[0]), dtype=torch.int8,
                             device="cuda", generator=gen(10))
    ms = {"K4": cuda_ms(lambda: quant.fused_mlp_int8(*args), 20)}
    if hasattr(quant, "_mlp_hidden_launch"):
        ms["K4a mlp_hidden"] = cuda_ms(
            lambda: quant._mlp_hidden_launch(*args[:5], "gelu_poly"), 20)
    ms["_int_mm pair"] = cuda_ms(lambda: (torch._int_mm(h_q, w1_q.t()),
                                          torch._int_mm(hidden_q, w2_q.t())),
                                 20)
    print(f"[time-mlp] {card}: {REPO}: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in ms.items()))


def forward_fc1(cfg) -> tuple:
    """What act_quant is handed in the ladder's int8+fq+v3 forward: the
    fc1 outputs of a full-width forward at B=128 cut to 2 layers (seeded
    random weights), caught at eva_scan's act_quant. Returns (the inputs,
    the activation)."""
    from dataclasses import replace

    from hirest_tpu_torch.models import eva_scan
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    cut = replace(cfg, layers=2)
    fn = eva_scan.build_scanned_vision_apply(
        random_eva_vision_state_dict(cut, seed=0), cut, int8=True,
        fused_quant=True, attn_v3=True, device="cuda")
    caught, acts = [], set()
    shipped = eva_scan.act_quant

    def catch(h, *, act="none"):
        caught.append(h.clone())
        acts.add(act)
        return shipped(h, act=act)

    eva_scan.act_quant = catch
    try:
        fn(normalize_frames(np.random.default_rng(5).integers(
            0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)))
    finally:
        eva_scan.act_quant = shipped
    torch.cuda.synchronize()
    require(len(acts) == 1, f"act_quant under several activations {acts}")
    return caught, acts.pop()


def sass_counts(lib: Path, kernel: str) -> None:
    """Prints, for each instantiation of `kernel` in the library's SASS
    (cuobjdump -sass), the values a thread holds a row (from its template
    arguments: K5's <act, G, units[, width]> units x 16, or width / G built
    in; ln_kernel's <kQuant, width> width / 32, or 64) and its f32
    multiplies, adds, FMAs, min/max, conversions to int, reciprocals and
    loads a value: one GELU evaluation a value shows as ~11 FMULs a value."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs: dict = {}
    name = None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]+\*/", line):
            body = line.split("*/", 1)[1].strip()
            body = re.sub(r"^@!?U?P[T0-9]+\s+", "", body)
            if body:
                funcs[name].append(body.split()[0].rstrip(";"))
    for fname, ops in funcs.items():
        if kernel not in fname:
            continue
        args = [int(a) for a in re.findall(r"Li(\d+)E", fname)]
        if kernel == "act_quant_kernel" and len(args) >= 3:
            values = args[2] * 16
            if len(args) > 3 and args[3]:
                values = min(values, args[3] // args[1])
        elif kernel == "act_quant_kernel":
            values = 32  # the row-per-block version's <act>: 8 vectors of 4
        else:
            values = args[0] // 32 if args and args[0] else 64
        base = [op.split(".")[0] for op in ops]
        count = {k: sum(op == k for op in base)
                 for k in ("FMUL", "FADD", "FFMA", "FMNMX", "F2I", "LDS",
                           "LDG")}
        count["MUFU.RCP"] = sum(op.startswith("MUFU.RCP") for op in ops)
        print(f"[sass] {fname} {args}: {values} values a thread, {len(ops)} "
              f"instructions; " + ", ".join(
                  f"{k} {n} ({n / values:.2f} a value)"
                  for k, n in count.items()))


def clocks_during(fn) -> tuple:
    """fn() while nvidia-smi samples the SM and memory clocks every 20 ms:
    (fn's result, "SM lo-hi MHz, memory lo-hi MHz over n samples" for the
    samples from fn's start until it returned)."""
    p = subprocess.Popen(["nvidia-smi", "-i", "0",
                          "--query-gpu=clocks.sm,clocks.mem",
                          "--format=csv,noheader,nounits", "-lms", "20"],
                         stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                         text=True)
    try:
        p.stdout.readline()  # sampling has begun
        result = fn()
    finally:
        p.terminate()
        text = p.communicate(timeout=30)[0]
    rows = [[int(v) for v in line.split(",")] for line in text.splitlines()
            if line.replace(",", "").replace(" ", "").isdigit()]
    if not rows:
        return result, "clocks not sampled"
    sm, mem = zip(*rows)
    return result, (f"SM {min(sm)}-{max(sm)} MHz, memory {min(mem)}-"
                    f"{max(mem)} MHz over {len(rows)} samples")


def kernel_ms(fn, key: str, n: int, before=None):
    """Mean device duration of the kernels whose name holds `key` over n
    calls of fn(), each after before() where given, from torch.profiler:
    the kernel's own time, without the gaps between launches; None where
    the profiler recorded no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and key in e.key:
            total += e.self_device_time_total
            count += e.count
    return total / count / 1e3 if count else None


def host_ms(fn, n: int) -> float:
    """The host's time a call to enqueue fn(), over n calls (fewer than the
    launch queue holds, so the card never holds the host back)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return t


def row_spread(x, g, b, card: str, others: dict) -> None:
    """Where K2's standalone time spreads. K2 on five fresh copies of x
    [M, 1408] (each at its own address): over 2000 calls back to back by
    CUDA events while nvidia-smi samples the clocks; the kernel's own
    device time over 200 such calls (kernel_ms) and the host's time a call
    (host_ms); and the kernel's own time over 50 calls each just after x
    was rewritten in place (its last rows still in L2, as in a forward,
    whose residual add writes x just before K2) and 50 just after the L2
    was flushed by a 256 MB write. Then the kernel's own time and the
    host's for each of `others` (name: (fn, kernel name key))."""
    from hirest_tpu_torch.ops import quant

    def fmt(t):
        return "not found" if t is None else f"{t:.4f} ms"

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    copies = []
    for r in range(5):
        xr = x.clone()
        copies.append(xr)  # kept, so that the next copy lies elsewhere

        def run():
            return quant.ln_quant(xr, g, b, EPS)

        ms, clocks = clocks_during(lambda: cuda_ms(run, 2000, 20))
        print(f"[time-rows] {card}: K2 on copy {r} of x "
              f"({xr.data_ptr():#x}): back to back {ms:.4f} ms ({clocks}), "
              f"the kernel's own "
              f"{fmt(kernel_ms(run, 'ln_kernel', 200))}, the host's "
              f"{host_ms(run, 200):.4f} ms a call; after x written "
              f"{fmt(kernel_ms(run, 'ln_kernel', 50, lambda: xr.mul_(1)))}"
              f", after the L2 flushed "
              f"{fmt(kernel_ms(run, 'ln_kernel', 50, flush.zero_))}")
    for name, (fn, key) in others.items():
        print(f"[time-rows] {card}: {name}: the kernel's own "
              f"{fmt(kernel_ms(fn, key, 200))}, the host's "
              f"{host_ms(fn, 200):.4f} ms a call")


def time_rows(cfg, card: str) -> None:
    """K2, K5 (gelu_bf16_poly at 6144, none at 1408) and K10 ms per call at
    B=128, beside F.layer_norm for K10 and a clone of K10's bytes, and K5
    on the fc1 outputs of an int8+fq+v3 forward, through the wrappers that
    every version of the port has (see time_attention); the kernels'
    ptxas registers where this call built them, and row_checks'
    differing counts, first; then where K2's time spreads and each row
    kernel's own device time (row_spread), and the SASS counts of both
    sources."""
    import torch.nn.functional as F

    from hirest_tpu_torch.ops import build, quant

    logs = build.build(("ln_quant", "act_quant"))
    ptxas_summary(logs.get("act_quant", ""), ("act_quant_kernel",))
    ptxas_summary(logs.get("ln_quant", ""), ("ln_kernel",))
    row_checks("time-rows")
    m, w, hid = BATCH * TOKENS, cfg.width, cfg.mlp_hidden
    x, g, b = ln_inputs(m, seed=8)
    x10, g10, b10 = ln_inputs(m, seed=17)
    h6, h1 = fc1_inputs(m, seed=15, c=hid), fc1_inputs(m, seed=16, c=w)
    # the short memory-bound calls first, 200 a time after 20 to warm up,
    # the GELU's heavy arithmetic last
    ms = {"K2": cuda_ms(lambda: quant.ln_quant(x, g, b, EPS), 200, 20),
          "K5 none": cuda_ms(lambda: quant.act_quant(h1), 200, 20),
          "K10": cuda_ms(lambda: quant.ln_bf16(x10, g10, b10, EPS), 200,
                         20),
          "F.layer_norm": cuda_ms(lambda: F.layer_norm(
              x10, (w,), g10.bfloat16(), b10.bfloat16(), EPS), 200, 20),
          # what the card's memory gives one PyTorch pass with K10's
          # traffic (bf16 in and out)
          "copy K10 bytes": cuda_ms(lambda: x10.clone(), 50),
          "K5 gelu_poly": cuda_ms(
              lambda: quant.act_quant(h6, act="gelu_poly"), 50, 5)}
    fc1, act = forward_fc1(cfg)
    for i, h in enumerate(fc1):
        ms[f"K5 {act} on layer {i}'s fc1"] = cuda_ms(
            lambda: quant.act_quant(h, act=act), 50)
    print(f"[time-rows] {card}: {REPO}: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in ms.items()))
    for what, h in [*((f"layer {i}'s fc1", h) for i, h in enumerate(fc1)),
                    ("the synthetic fc1", h6)]:
        y = quant._act(act, quant.QUANT_ACTS)(h.float())
        print(f"[time-rows] {what} {tuple(h.shape)}: |x| mean "
              f"{h.float().abs().mean().item():.4f}, max "
              f"{h.float().abs().max().item():.4f}; {act} gives y == 0 on "
              f"{(y == 0).float().mean().item():.6f} of it, |y| < 1e-3 on "
              f"{(y.abs() < 1e-3).float().mean().item():.6f}")
    row_spread(x, g, b, card, {
        "K10": (lambda: quant.ln_bf16(x10, g10, b10, EPS), "ln_kernel"),
        "K5 none": (lambda: quant.act_quant(h1), "act_quant_kernel"),
        "K5 gelu_poly": (lambda: quant.act_quant(h6, act="gelu_poly"),
                         "act_quant_kernel")})
    for name, kernel in (("act_quant", "act_quant_kernel"),
                         ("ln_quant", "ln_kernel")):
        sass_counts(build.library_path(name), kernel)


def ptxas_summary(log: str, kernels) -> None:
    """Each named kernel's registers and spills from nvcc's ptxas -v log,
    and why ptxas serialized its wgmma instructions, where it did."""
    lines = log.splitlines()
    for name in kernels:
        at = [i for i, line in enumerate(lines)
              if "Compiling entry function" in line and name in line]
        for i in at:
            props = " ".join(line.split("info    :")[-1].strip()
                             for line in lines[i + 1:i + 4]
                             if "bytes stack" in line or "Used" in line)
            entry = lines[i].split("'")[1] if "'" in lines[i] else name
            serial = {line.split("serialized ")[-1].split(" for the")[0]
                      for line in lines
                      if "wgmma.mma_async instructions are serialized" in line
                      and entry in line}
            if serial:
                props += f"; wgmma serialized {', '.join(sorted(serial))}"
            print(f"[build] ptxas {entry}: {props}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 1
    from hirest_tpu_torch.config import EvaTextConfig, EvaVisionConfig
    from hirest_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    cfg, text_cfg = EvaVisionConfig(), EvaTextConfig()
    pretrained = REPO / "pretrained_weights"

    timers = {"--time-attention": lambda: time_attention(cfg, card),
              "--time-mlp": lambda: time_mlp(card),
              "--time-rows": lambda: time_rows(cfg, card)}
    asked = [flag for flag in timers if flag in sys.argv[1:]]
    for flag in asked:
        timers[flag]()
    if asked:
        return 0
    t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {len(logs)} CUDA sources compiled in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"[build] {name}:\n{log.strip()}")
    from hirest_tpu_torch.ops.quant import mlp_int8_smem_bytes

    ptxas_summary(logs.get("fused_mlp_int8", ""),
                  ("fused_mlp_int8_hidden_kernel",
                   "fused_mlp_int8_out_kernel"))
    ptxas_summary(logs.get("attention_qkv3", ""), ("attention_qkv3_kernel",))
    ptxas_summary(logs.get("act_quant", ""), ("act_quant_kernel",))
    ptxas_summary(logs.get("ln_quant", ""), ("ln_kernel",))
    print(f"[build] K4 dynamic shared memory a block: "
          f"{mlp_int8_smem_bytes()}")

    errs = phase_kernels(cfg)
    if "--kernels-only" in sys.argv[1:]:
        print(f"chip_smoke: build and kernels phases passed on {card}")
        return 0
    main_res = phase_main(cfg, pretrained)
    weights = factory_weights(cfg, text_cfg, pretrained)
    factory = phase_factory(cfg, text_cfg, weights)
    ladder = phase_ladder(cfg, weights)
    frames = phase_depth(cfg, pretrained)
    phase_factory_depth(cfg, text_cfg, weights, frames)
    phase_ladder_depth(cfg, frames)
    timing = phase_timing(cfg, main_res, factory, ladder, card)
    phase_profile(cfg, main_res, factory, ladder, card)
    phase_serving(main_res, card)
    launches = {**ladder["launches"], **factory["launches"],
                **main_res["launches"]}

    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[k], "max_abs_err": errs[k],
        **timing[k]} for k, (name, src, replaces) in SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
