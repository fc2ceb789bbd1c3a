"""Bench: EVA-CLIP-g frame-encoding throughput of the port on one NVIDIA H100.

Counterpart of the JAX package's root bench.py. Run it as

    python -m hirest_tpu_torch.bench                 # the ladder, B=128
    python -m hirest_tpu_torch.bench --int8          # int8+fq+v3+fm alone
    python -m hirest_tpu_torch.bench --bf16          # bf16+v3 alone
    python -m hirest_tpu_torch.bench --unrolled [--int8 | --bf16]
    python -m hirest_tpu_torch.bench --latency | --vr | --e2e [--int8]
    python -m hirest_tpu_torch.bench --cpu-smoke     # the CPU, untimed

Other flags: --batch=128[,256,...], --budget=SECONDS (the ladder's wall
budget, 1500 by default), --padded-heads (heads 88 -> 128), --experiment
(records only under "experiments"), and the remaps of bench.py:769-789:
--fused-quant, --attn-v2, --attn-v3, --fused-ln, --fused-mlp.

It prints the card's name and power limit (nvidia-smi's
`name,power.limit`) and, last, one JSON line:

  {"metric": "eva_clip_frames_per_sec_per_chip", "value": N,
   "unit": "frames/sec", "mfu": ..., "config": {"batch", "config",
   "precision"}, "useful_tflops_per_frame": ..., "peak_basis_bf16_tflops":
   ..., "bf16_ceiling_fps": ..., "int8_ceiling_fps": ...}

or the mode's own metric (step_caption_p50_latency in ms,
video_retrieval_queries_per_sec, e2e_extraction_frames_per_sec). `mfu` is
the useful-FLOP rate (the logical model's matmul FLOP a frame, head width
88) over the card's dense bf16 peak. Weights are seeded random: they do
not change the time.

The clock: wall time over `iters` forwards (8) after the first call
("build + first": the kernels' nvcc build at first use, the allocator) and
two warm-ups, ending in a host fetch (`.cpu()`) of the last output, which
waits for the device as bench.py's `np.asarray` does.

The ladder is bench.py's (:734-768) without its TPU layout flags
(flat2d, pad_tokens, attn_hg, attn_rows), duplicates merged: eight
configurations of build_scanned_vision_apply, one staged tower a precision.
A configuration that fails to build or run is reported on stderr and in
the line's "failed", and the run exits 1.

Refused, with a line saying why: --no-pallas (a plain version on the main
path), --flat2d, --tok-pad, --hg=, --rows= (TPU layouts), --no-cache (JAX's
compilation cache). The TPU queue lock and the /tmp cache of the flax
parameter tree are not carried. Where no CUDA device is found, or the card
is not in the peak table, it prints a zero-value line with "error" and
exits 1; it never times anything on the CPU.

The port's last good results go to BENCH_TORCH_LAST_GOOD.json at the
repository root (git-ignored); a fail-fast line attaches them, never in
place of its value.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from hirest_tpu_torch.config import (EvaTextConfig, EvaVisionConfig,
                                     JointModelConfig)
from hirest_tpu_torch.models.eva_clip import (build_unrolled_vision_apply,
                                              eva_text_encoder,
                                              preprocess_image_u8)
from hirest_tpu_torch.models.eva_pad import pad_vision_head_params
from hirest_tpu_torch.models.eva_quant import build_int8_vision_apply
from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                              stage_scanned_params)
from hirest_tpu_torch.utils.device import resolve_device
from hirest_tpu_torch.utils.init import (random_eva_text_state_dict,
                                         random_eva_vision_state_dict,
                                         random_moment_state_dict)

LAST_RESULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "BENCH_TORCH_LAST_GOOD.json")

# dense bf16 tensor-core peak by torch.cuda.get_device_name (NVIDIA's data
# sheet, SXM part, at 700 W); the int8 peak is twice it
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989.4e12}
BASIS_CARD = "NVIDIA H100 80GB HBM3"  # the basis where no card is probed

FPS_METRIC = "eva_clip_frames_per_sec_per_chip"
UNITS = {FPS_METRIC: "frames/sec",
         "step_caption_p50_latency": "ms",
         "video_retrieval_queries_per_sec": "queries/sec",
         "e2e_extraction_frames_per_sec": "frames/sec"}

REFUSED = {
    "--no-pallas": "it would put the plain versions on the main path (a "
                   "CUDA tensor always takes the kernels)",
    "--flat2d": "a TPU layout flag: the port computes the same numbers "
                "without it",
    "--tok-pad": "a TPU layout flag (tokens 257 -> 264): the port runs "
                 "its 257 tokens unpadded",
    "--hg": "a TPU layout flag (heads per batched dot)",
    "--rows": "a TPU layout flag (images per attention grid cell)",
    "--no-cache": "it configures JAX's compilation cache; the port builds "
                  "its CUDA sources once into build/kernels/",
}


class LadderConfig(NamedTuple):
    """One kernel flag configuration of the scanned forward; `attn` is
    bench.py's kernel version: 0 = v1 (K8), 1 = v2 (K9), 2 = v3 (K1/K3)."""
    int8: bool
    fused_quant: bool = False
    attn: int = 0
    fused_ln: bool = False
    fused_mlp: bool = False


# bench.py:754-768 less flat2d and pad_tokens, duplicates merged, in order
LADDER = (
    LadderConfig(True, True, 2, fused_mlp=True),  # the production int8
    LadderConfig(True, True, 2),
    LadderConfig(False, attn=2),                  # the production bf16
    LadderConfig(True),                           # int8 dyn, v1
    LadderConfig(False),                          # v1
    LadderConfig(False, attn=1),
    LadderConfig(False, attn=2, fused_ln=True),
    LadderConfig(True, True, 1),
)


def consumed(c: LadderConfig, scan: bool = True) -> LadderConfig:
    """The flags the forward reads (build_scanned_vision_apply): fused_quant
    only with int8, fused_mlp only with fused_quant, fused_ln only without
    int8; the unrolled towers read int8 alone."""
    if not scan:
        return LadderConfig(c.int8)
    fq = c.fused_quant and c.int8
    return LadderConfig(c.int8, fq, c.attn, c.fused_ln and not c.int8,
                        c.fused_mlp and fq)


def config_tag(c: LadderConfig, padded: bool = False,
               scan: bool = True) -> str:
    """bench.py:817-823's tag, naming only the knobs the forward consumes."""
    c = consumed(c, scan)
    return (("int8" if c.int8 else "bf16") + ("+fq" if c.fused_quant else "")
            + ("", "+v2", "+v3")[c.attn] + ("+lnk" if c.fused_ln else "")
            + ("+pad" if padded else "") + ("+fm" if c.fused_mlp else "")
            + ("" if scan else "+unrolled"))


def ladder_kwargs(c: LadderConfig) -> dict:
    """What bench.py's main hands build_eva_apply for a configuration
    (:834-842), less the layout flags."""
    return dict(int8=c.int8, fused_quant=c.fused_quant, attn_v2=c.attn == 1,
                attn_v3=c.attn == 2, fused_mlp=c.fused_mlp and c.fused_quant,
                fused_ln=c.fused_ln)


def build_ladder(args: argparse.Namespace) -> list:
    """The configurations to run, after --int8/--bf16 and the remaps of
    bench.py:769-789, each reduced to what it consumes, duplicates merged."""
    ladder = ([LADDER[0]] if args.int8 else [LADDER[2]] if args.bf16
              else list(LADDER))
    if args.fused_quant or args.attn_v2 or args.attn_v3:
        kv = 2 if args.attn_v3 else 1 if args.attn_v2 else 0
        ladder = [c._replace(fused_quant=args.fused_quant and c.int8,
                             attn=kv) for c in ladder]
    if args.fused_ln:
        ladder = [c._replace(fused_ln=not c.int8) for c in ladder]
    if args.fused_mlp:
        ladder = [c._replace(fused_mlp=c.fused_quant) for c in ladder]
    return list(dict.fromkeys(consumed(c, not args.unrolled)
                              for c in ladder))


def eva_useful_tflops_per_frame(cfg: Optional[EvaVisionConfig] = None
                                ) -> float:
    """Analytic matmul FLOP (2*M*N*K) a frame of the logical EVA-g/14 model
    at 224 px, head width 88 and no padding, in TFLOP (bench.py:70-87)."""
    cfg = cfg or EvaVisionConfig()
    n = cfg.num_patches + 1
    w = cfg.width
    inner = (w // cfg.head_width) * cfg.head_width  # 1408
    per_layer = (
        2 * w * 3 * inner          # qkv projection
        + 4 * n * inner            # scores + weighted sum (per token)
        + 2 * inner * w            # out projection
        + 4 * w * cfg.mlp_hidden   # MLP up + down
    ) * n
    patch = 2 * (cfg.patch_size ** 2 * 3) * w * (n - 1)
    head = 2 * w * cfg.embed_dim
    return (cfg.layers * per_layer + patch + head) / 1e12


def _physics_context(peak_tf: float,
                     cfg: Optional[EvaVisionConfig] = None) -> dict:
    """Roofline fields of the frames/s metric against `peak_tf`, the dense
    bf16 TFLOP/s its mfu is taken against."""
    tf = eva_useful_tflops_per_frame(cfg)
    return {"useful_tflops_per_frame": round(tf, 4),
            "peak_basis_bf16_tflops": round(peak_tf, 1),
            "bf16_ceiling_fps": round(peak_tf / tf, 1),
            "int8_ceiling_fps": round(2 * peak_tf / tf, 1)}


def build_host_params(padded_heads: bool,
                      cfg: Optional[EvaVisionConfig] = None):
    """The seeded EVA vision state dict (f32 numpy, or f32 tensors once
    padded) and its config, heads padded 88 -> 128 when asked."""
    cfg = cfg or EvaVisionConfig()
    params = random_eva_vision_state_dict(cfg, seed=0)
    if padded_heads:
        params, cfg = pad_vision_head_params(params, cfg)
    return params, cfg


def build_eva_apply(params, cfg, int8: bool = False, scan: bool = True,
                    dtype_name: str = "bfloat16", fused_quant: bool = False,
                    attn_v2: bool = False, attn_v3: bool = False,
                    fused_ln: bool = False, staged=None,
                    uint8_input: bool = False, fused_mlp: bool = False,
                    device=None):
    """-> apply(images) on `device` (bench.py:160-199): the scanned forward
    with these flags (on `staged`, a tower staged before, when given), or
    with scan=False the unrolled int8 tower (int8) or the unrolled float
    tower."""
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    if scan:
        return build_scanned_vision_apply(
            params, cfg, int8=int8, dtype=dtype, fused_quant=fused_quant,
            attn_v2=attn_v2, attn_v3=attn_v3, fused_ln=fused_ln,
            staged=staged, uint8_input=uint8_input, fused_mlp=fused_mlp,
            device=device)
    if int8:
        return build_int8_vision_apply(params, cfg, dtype=dtype,
                                       device=device)
    return build_unrolled_vision_apply(params, cfg, dtype=dtype,
                                       device=device)


def bench_eva_vision(apply, batch_size: int = 128, iters: int = 8,
                     warmup: int = 2, image_size: int = 224,
                     device=None) -> float:
    """Frames/s of `apply` on seeded normal NHWC bf16 images on `device`."""
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch_size, image_size, image_size, 3))).to(
            device=device, dtype=torch.bfloat16)

    t0 = time.perf_counter()
    apply(imgs).cpu()  # the kernels' build at first use + the first run
    first_s = time.perf_counter() - t0

    for _ in range(warmup):
        apply(imgs).cpu()

    start = time.perf_counter()
    out = None
    for _ in range(iters):
        out = apply(imgs)
    out.cpu()  # waits for the device queue
    elapsed = time.perf_counter() - start
    print(f"#   build+first {first_s:.1f}s", file=sys.stderr)
    return batch_size * iters / elapsed


def _ensure_bench_frames(n_frames: int, size=(640, 360)) -> Path:
    """One video's worth of JPEG frames under the temp directory, made once
    (bench.py:229-259): low-frequency content, shifted frame to frame so
    that no two frames are byte-identical."""
    from PIL import Image

    root = (Path(tempfile.gettempdir()) / "hirest_torch_bench_frames_v1"
            / f"{size[0]}x{size[1]}_{n_frames}")
    video = root / "video0"
    done = root / ".done"
    if done.exists():
        return root
    video.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(32, 48, 3), dtype=np.uint8)
    n_unique = base.shape[0] * base.shape[1]
    if n_frames > n_unique:
        raise ValueError(f"frame synthesis keeps frames distinct only up to "
                         f"{n_unique}")
    for i in range(n_frames):
        arr = np.roll(np.roll(base, i % base.shape[0], axis=0),
                      i // base.shape[0], axis=1)
        img = Image.fromarray(arr).resize(size, Image.BICUBIC)
        img.save(video / f"frame_{i + 1:010d}.jpg", quality=85)
    done.touch()
    return root


def bench_e2e_extraction(params, cfg, batch_size: int = 128,
                         n_frames: int = 1024, decode_workers: int = 4,
                         int8: bool = False, staged=None, iters: int = 8,
                         warmup: int = 2, device=None) -> dict:
    """End-to-end extraction (bench.py:262-324): host JPEG decode and
    resize, uint8 frames to the device, the production forward with the
    uint8 front end, the prefetch overlap on; beside the model-only frames/s
    of the same forward on uint8 frames from the host (the ratio's
    denominator)."""
    from hirest_tpu_torch.extraction.features import extract_video_features

    apply = build_eva_apply(params, cfg, int8=int8, staged=staged,
                            attn_v3=True, fused_quant=int8, fused_mlp=int8,
                            uint8_input=True, device=device)
    s = cfg.image_size
    apply(np.zeros((batch_size, s, s, 3), np.uint8)).cpu()  # outside timing

    imgs = np.random.default_rng(0).integers(
        0, 255, size=(batch_size, s, s, 3), dtype=np.uint8)
    for _ in range(warmup):
        apply(imgs).cpu()
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = apply(imgs)
    out.cpu()
    model_fps = batch_size * iters / (time.perf_counter() - t0)

    frame_root = _ensure_bench_frames(n_frames)
    out_dir = tempfile.mkdtemp(prefix="hirest_torch_bench_e2e_")
    try:
        t0 = time.perf_counter()
        extract_video_features(
            str(frame_root), out_dir, apply,
            functools.partial(preprocess_image_u8, image_size=s), batch_size,
            normalize=True, decode_workers=decode_workers)
        elapsed = time.perf_counter() - t0
        feats = np.load(os.path.join(out_dir, "video0.npy"))
        if feats.shape != (n_frames, cfg.embed_dim):
            raise RuntimeError(f"features {feats.shape}, expected "
                               f"{(n_frames, cfg.embed_dim)}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    e2e_fps = n_frames / elapsed
    return {"e2e_fps": e2e_fps, "model_only_fps": model_fps,
            "overlap_efficiency": e2e_fps / model_fps,
            "batch": batch_size, "n_frames": n_frames,
            "decode_workers": decode_workers,
            "precision": "int8" if int8 else "bf16"}


def bench_caption_latency(batch_size: int = 1, beam: int = 3,
                          max_words: int = 48, iters: int = 20,
                          cfg: Optional[JointModelConfig] = None,
                          device=None) -> float:
    """p50 step-caption decode latency in ms (bench.py:327-375): the
    KV-cached beam over MomentModel at JointModelConfig()'s width, f32,
    seeded weights; each decode ends in one host fetch of its ids. The
    decode runs eagerly, step by step, where JAX's is one jitted program."""
    from hirest_tpu_torch.infer.beam import beam_search_cached
    from hirest_tpu_torch.models.joint import MomentModel

    cfg = cfg or JointModelConfig()
    with torch.device("meta"):
        model = MomentModel(cfg)
    sd = random_moment_state_dict(cfg, seed=0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          assign=True)
    model = model.to(device).eval()
    b = batch_size
    video = torch.zeros(b, cfg.max_frames_step_captioning, cfg.clip_dim,
                        device=device)
    text = torch.zeros(b, cfg.clip_dim, device=device)
    dec = model.decoder

    @torch.inference_mode()
    def decode():
        vis = model.caption_encode(video, text)
        cross_kv = dec.cross_kv(vis.repeat_interleave(beam, dim=0))

        def step_fn(last, t, cache):
            return dec.decode_step(last, t, cross_kv, cache)

        def gather_fn(cache, src):
            return tuple((k[src], v[src]) for k, v in cache)

        ids, _ = beam_search_cached(
            step_fn, gather_fn, dec.init_cache(b * beam, max_words + 1), b,
            beam, max_words, 101, 102, device=device)
        return ids

    decode().cpu()  # the first decode, untimed
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        decode().cpu()
        times.append(time.perf_counter() - start)
    return float(np.percentile(times, 50) * 1000)


def bench_retrieval_qps(n_prompts: int = 64, n_videos: int = 4282,
                        iters: int = 5, cfg: Optional[EvaTextConfig] = None,
                        device=None) -> float:
    """Retrieval scoring queries/s (bench.py:378-408): the EVA text tower
    in bf16 on `n_prompts` prompts, L2-normalised, scored against
    `n_videos` video embeddings; the scores reach the host every call."""
    cfg = cfg or EvaTextConfig()
    encode_text = eva_text_encoder(random_eva_text_state_dict(cfg, seed=0),
                                   cfg, torch.bfloat16, device)
    ids = torch.zeros((n_prompts, cfg.context_length), dtype=torch.long)
    # SOT and EOT: the vocabulary's last two ids (49406, 49407 in CLIP's)
    ids[:, 0], ids[:, 1] = cfg.vocab_size - 2, cfg.vocab_size - 1
    ids = ids.to(device)
    video_embeds = torch.from_numpy(np.random.default_rng(0).normal(
        size=(n_videos, cfg.embed_dim))).to(device=device,
                                            dtype=torch.bfloat16)

    @torch.inference_mode()
    def score():
        t = encode_text(ids)
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
        return t @ video_embeds.T.float()

    score().cpu()  # the first call, untimed
    start = time.perf_counter()
    for _ in range(iters):
        score().cpu()
    return n_prompts * iters / (time.perf_counter() - start)


def _estimate_dispatch_rtt_ms(device=None, iters: int = 8) -> float:
    """Median wall time of a one-element add on the device and its fetch:
    the floor every wall-clock metric pays a call (bench.py:411-431)."""
    x = torch.zeros(8, device=device)
    (x + 1).cpu()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        (x + 1).cpu()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1000)


def _active_metric_name(argv: list) -> str:
    if "--latency" in argv:
        return "step_caption_p50_latency"
    if "--vr" in argv:
        return "video_retrieval_queries_per_sec"
    if "--e2e" in argv:
        return "e2e_extraction_frames_per_sec"
    return FPS_METRIC


def _read_last_good() -> dict:
    """The port's record ({metric: result}), {} where there is none."""
    try:
        with open(LAST_RESULT_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _write_last_good(data: dict) -> None:
    tmp = LAST_RESULT_PATH + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, LAST_RESULT_PATH)


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _record_last_good(result: dict) -> None:
    """Merge a result measured on the card into the port's record."""
    try:
        data = _read_last_good()
        data[result["metric"]] = {**result, "measured_at": _now()}
        _write_last_good(data)
    except OSError as e:
        print(f"# last-good record failed: {e}", file=sys.stderr)


def _record_config_result(tag: str, batch: int, fps: float, mfu: float,
                          headline: Optional[dict]) -> None:
    """Merge one ladder configuration's numbers as soon as it completes:
    under "experiments" always, and as the headline when `headline` (a
    production run) beats the stored one."""
    try:
        data = _read_last_good()
        now = _now()
        data.setdefault("experiments", {})[f"{tag}@b{batch}"] = {
            "fps": round(fps, 2), "mfu": round(mfu, 4), "measured_at": now}
        if headline is not None:
            metric = headline["metric"]
            if fps > data.get(metric, {}).get("value", 0.0):
                data[metric] = {**headline, "measured_at": now}
        _write_last_good(data)
    except OSError as e:
        print(f"# per-config record failed: {e}", file=sys.stderr)


def _fail_fast(error: str, metric: str, code: int = 1):
    """Print a zero-value JSON line with `error` and exit `code`. The
    port's record is attached for context, never in place of the value."""
    fail = {"metric": metric, "value": 0.0, "unit": UNITS[metric],
            "error": error}
    last = _read_last_good()
    if metric in last:
        fail["last_measured"] = last[metric]
    if last:
        fail["last_measured_all"] = last
    if metric == FPS_METRIC:
        fail.update(_physics_context(PEAK_BF16[BASIS_CARD] / 1e12))
    print(json.dumps(fail), flush=True)
    sys.exit(code)


def _require_device(metric: str):
    """(device, its dense bf16 peak) of the card, or the fail-fast line."""
    try:
        device = resolve_device("cuda")
    except RuntimeError:
        _fail_fast("no CUDA device found: the bench measures the card and "
                   "never times the CPU (--cpu-smoke checks the program "
                   "there, untimed)", metric)
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_BF16:
        _fail_fast(f"card {name!r} is not in the peak table "
                   f"({', '.join(PEAK_BF16)}): its mfu and ceilings would "
                   f"have no basis", metric)
    return device, PEAK_BF16[name]


def card_name_and_power() -> str:
    """nvidia-smi's `name,power.limit` line for the card."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"
    return r.stdout.strip().splitlines()[0]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m hirest_tpu_torch.bench",
                                allow_abbrev=False)
    for flag in ("--int8", "--bf16", "--unrolled", "--padded-heads",
                 "--experiment", "--fused-quant", "--attn-v2", "--attn-v3",
                 "--fused-ln", "--fused-mlp", "--latency", "--vr", "--e2e",
                 "--cpu-smoke"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--batch", type=lambda s: [int(x) for x in s.split(",")],
                   default=[128], help="batch sizes, comma-separated")
    p.add_argument("--budget", type=float, default=1500.0,
                   help="the ladder's wall budget in seconds")
    return p


def _report(result: dict) -> int:
    print(card_name_and_power())
    print(json.dumps(result))
    _record_last_good(result)
    return 0


def run_ladder(ladder: list, vision_cfg: Optional[EvaVisionConfig],
               padded: bool, batches: list, scan: bool, device, smoke: bool,
               budget_s: float, on_result) -> dict:
    """Each configuration at each batch, one staged tower a precision (the
    host weights freed once no configuration left needs them);
    `on_result(tag, c, batch, fps)` after each. Returns {tag: error} of
    those that failed."""
    t0 = time.perf_counter()
    params, cfg = build_host_params(padded, vision_cfg)
    print(f"# host params built in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    failed = {}
    staged_by_prec = {}
    t0 = time.perf_counter()
    for i, c in enumerate(ladder):
        if time.perf_counter() - t0 > budget_s:
            print(f"# ladder budget {budget_s:.0f}s exhausted; skipping "
                  f"remaining configs", file=sys.stderr)
            break
        tag = config_tag(c, padded, scan)
        try:
            if scan and c.int8 not in staged_by_prec:
                t1 = time.perf_counter()
                staged_by_prec[c.int8] = stage_scanned_params(
                    params, cfg, int8=c.int8, dtype=torch.bfloat16,
                    device=device)
                print(f"# staged {'int8' if c.int8 else 'bf16'} params in "
                      f"{time.perf_counter() - t1:.1f}s", file=sys.stderr)
            apply = build_eva_apply(params, cfg, scan=scan,
                                    staged=staged_by_prec.get(c.int8),
                                    device=device, **ladder_kwargs(c))
        except Exception as e:  # reported, and the run exits 1
            failed[tag] = f"build: {type(e).__name__}: {e}"
            print(f"# build {tag} failed: {failed[tag]}", file=sys.stderr)
            continue
        rest = ladder[i + 1:]
        if not (any(r.int8 not in staged_by_prec for r in rest) if scan
                else rest):
            params = None  # every forward left runs on a staged tower
        for b in batches:
            try:
                fps = bench_eva_vision(apply, batch_size=b,
                                       iters=1 if smoke else 8,
                                       warmup=0 if smoke else 2,
                                       image_size=cfg.image_size,
                                       device=device)
            except Exception as e:  # reported, and the run exits 1
                failed[tag] = f"batch {b}: {type(e).__name__}: {e}"
                print(f"# batch {b} {tag} failed: {failed[tag]}",
                      file=sys.stderr)
                continue
            on_result(tag, c, b, fps)
    return failed


def cpu_smoke(vision_cfg, text_cfg, joint_cfg) -> int:
    """Every ladder configuration once on the CPU at batch 2 (the kernels'
    plain versions), then the three secondary modes at small sizes; prints
    which ran, and no time."""
    cpu = torch.device("cpu")
    status = {}

    def ok(tag, c, b, fps):
        status[tag] = "ok"
        print(f"# smoke {tag}: ok", file=sys.stderr)

    status.update(run_ladder(list(LADDER), vision_cfg, False, [2], True,
                             cpu, True, float("inf"), ok))
    params, cfg = build_host_params(False, vision_cfg)
    for name, fn in (
            ("latency", lambda: bench_caption_latency(
                iters=2, cfg=joint_cfg, device=cpu)),
            ("vr", lambda: bench_retrieval_qps(iters=1, cfg=text_cfg,
                                               device=cpu)),
            ("e2e", lambda: bench_e2e_extraction(
                params, cfg, batch_size=2, n_frames=8, decode_workers=0,
                iters=1, warmup=0, device=cpu))):
        try:
            fn()
            status[name] = "ok"
        except Exception as e:  # reported, and the smoke exits 1
            status[name] = f"FAILED: {type(e).__name__}: {e}"
        print(f"# smoke {name}: {status[name]}", file=sys.stderr)
    print(json.dumps({
        "metric": FPS_METRIC, "value": 0.0, "unit": "frames/sec",
        "mfu": 0.0, "config": {"batch": 2, "device": "cpu"},
        "smoke": status,
        **_physics_context(PEAK_BF16[BASIS_CARD] / 1e12, vision_cfg)}))
    return 0 if all(v == "ok" for v in status.values()) else 1


def main(argv: Optional[list] = None, *,
         vision_cfg: Optional[EvaVisionConfig] = None,
         text_cfg: Optional[EvaTextConfig] = None,
         joint_cfg: Optional[JointModelConfig] = None) -> int:
    """The bench on `argv` (sys.argv[1:] by default); the configs default
    to EVA-CLIP-g's towers and JointModelConfig()."""
    argv = sys.argv[1:] if argv is None else list(argv)
    metric = _active_metric_name(argv)
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in REFUSED:
            _fail_fast(f"{flag} is refused: {REFUSED[flag]}", metric, code=2)
    args = _parser().parse_args(argv)
    if args.cpu_smoke:
        return cpu_smoke(vision_cfg, text_cfg, joint_cfg)
    device, peak = _require_device(metric)

    if args.latency:
        rtt = _estimate_dispatch_rtt_ms(device)
        p50 = bench_caption_latency(cfg=joint_cfg, device=device)
        return _report({
            "metric": "step_caption_p50_latency",
            "value": round(max(p50 - rtt, 0.0), 2), "unit": "ms",
            "detail": {"p50_wall_ms": round(p50, 2),
                       "dispatch_rtt_ms": round(rtt, 4),
                       "basis": "wall minus measured dispatch RTT (one "
                                "host fetch per decode)"}})
    if args.vr:
        rtt = _estimate_dispatch_rtt_ms(device)
        iters, n_prompts = 5, 64
        qps = bench_retrieval_qps(n_prompts=n_prompts, iters=iters,
                                  cfg=text_cfg, device=device)
        wall_s = n_prompts * iters / qps
        net_s = max(wall_s - iters * rtt / 1000.0, 1e-9)
        return _report({
            "metric": "video_retrieval_queries_per_sec",
            "value": round(n_prompts * iters / net_s, 2),
            "unit": "queries/sec",
            "detail": {"wall_qps": round(qps, 2),
                       "dispatch_rtt_ms": round(rtt, 4), "iters": iters,
                       "n_prompts": n_prompts,
                       "basis": "wall minus measured dispatch RTT (one "
                                "host fetch per scoring call)"}})
    if args.e2e:
        rtt = _estimate_dispatch_rtt_ms(device)
        params, cfg = build_host_params(False, vision_cfg)
        r = bench_e2e_extraction(params, cfg, int8=args.int8, device=device)
        e2e_fps = r.pop("e2e_fps")
        # a dispatch RTT a batch, as bench.py nets one fetch a batch: each
        # batch's copy to the device waits for the forward before it
        n_batches = -(-r["n_frames"] // r["batch"])
        net_s = max(r["n_frames"] / e2e_fps - n_batches * rtt / 1000.0, 1e-9)
        mo_batch_s = r["batch"] / r["model_only_fps"]
        mo_net_fps = r["batch"] / max(mo_batch_s - rtt / 1000.0, 1e-9)
        r.update(e2e_wall_fps=e2e_fps, dispatch_rtt_ms=rtt,
                 model_only_net_fps=mo_net_fps,
                 overlap_efficiency_net=r["n_frames"] / net_s / mo_net_fps)
        return _report({
            "metric": "e2e_extraction_frames_per_sec",
            "value": round(r["n_frames"] / net_s, 2), "unit": "frames/sec",
            "detail": {k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in r.items()}})

    scan = not args.unrolled
    ladder = build_ladder(args)
    tf_per_frame = eva_useful_tflops_per_frame(vision_cfg)
    best = {"fps": 0.0, "config": {}}

    def record(tag, c, b, fps):
        mfu = fps * tf_per_frame * 1e12 / peak
        print(f"# batch {b} {tag}: {fps:.2f} fps ({fps * tf_per_frame:.1f} "
              f"useful TF/s, {100 * mfu:.1f}% of bf16 peak)", file=sys.stderr)
        cfg_line = {"batch": b, "config": tag,
                    "precision": "int8" if c.int8 else "bf16"}
        if fps > best["fps"]:
            best.update(fps=fps, config=cfg_line)
        headline = None if args.experiment else {
            "metric": FPS_METRIC, "value": round(fps, 2),
            "unit": "frames/sec", "mfu": round(mfu, 4), "config": cfg_line,
            **_physics_context(peak / 1e12, vision_cfg)}
        _record_config_result(tag, b, fps, mfu, headline)

    failed = run_ladder(ladder, vision_cfg, args.padded_heads, args.batch,
                        scan, device, False, args.budget, record)
    result = {"metric": FPS_METRIC, "value": round(best["fps"], 2),
              "unit": "frames/sec",
              "mfu": round(best["fps"] * tf_per_frame * 1e12 / peak, 4),
              "config": best["config"],
              **_physics_context(peak / 1e12, vision_cfg)}
    if failed:
        result["failed"] = failed
    print(card_name_and_power())
    print(json.dumps(result))
    if failed or best["fps"] == 0.0:
        return 1
    if not args.experiment:
        _record_last_good(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
