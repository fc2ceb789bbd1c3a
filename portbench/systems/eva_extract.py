"""Frame extraction through the port's EVA vision tower: the system of the
EVA-CLIP configurations.

From the program this takes only its entry points: the scanned tower's
`build_scanned_vision_apply` with the flags the configuration file names,
`data.prefetch.prefetch` and `extraction.features.finish_video_features`.
The configuration's `flags` decide the front end: with `uint8_input` the
batches are raw uint8 frames, without it CLIP's normalised float32 pixels,
as `preprocess_image` makes them.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from portbench import inputs
from portbench.records import Request, Window
from portbench.references.eva_clip_vision import Reference, normalise

# EvaVisionConfig's fields, as a configuration file names them
EVA_FIELDS = ("image_size", "layers", "width", "head_width", "mlp_ratio",
              "patch_size", "embed_dim", "norm_eps")
SCALE = 0.02  # the weights' standard deviation; LayerNorm weights sit at 1
SERVED = torch.bfloat16  # the type the checkpoint's weights are served in


def vision_shapes(cfg: dict) -> dict:
    """Key -> shape of every tensor of the EVA vision tower, with the EVA
    reference's names (EVA_clip/vit_model.py) and without `visual.`."""
    w, p = cfg["width"], cfg["patch_size"]
    inner = (w // cfg["head_width"]) * cfg["head_width"]
    hid = int(w * cfg["mlp_ratio"])
    n = (cfg["image_size"] // p) ** 2 + 1
    shapes = {
        "patch_embed.proj.weight": (w, 3, p, p),
        "patch_embed.proj.bias": (w,),
        "cls_token": (1, 1, w),
        "pos_embed": (1, n, w),
        "norm.weight": (w,),
        "norm.bias": (w,),
        "head.weight": (cfg["embed_dim"], w),
        "head.bias": (cfg["embed_dim"],),
    }
    for i in range(cfg["layers"]):
        b = f"blocks.{i}"
        shapes.update({
            f"{b}.norm1.weight": (w,), f"{b}.norm1.bias": (w,),
            f"{b}.attn.qkv.weight": (3 * inner, w),
            f"{b}.attn.q_bias": (inner,), f"{b}.attn.v_bias": (inner,),
            f"{b}.attn.proj.weight": (w, inner), f"{b}.attn.proj.bias": (w,),
            f"{b}.norm2.weight": (w,), f"{b}.norm2.bias": (w,),
            f"{b}.mlp.fc1.weight": (hid, w), f"{b}.mlp.fc1.bias": (hid,),
            f"{b}.mlp.fc2.weight": (w, hid), f"{b}.mlp.fc2.bias": (w,),
        })
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The weights on `device` in bf16, the type they are served in: normal
    at SCALE (LayerNorm weights at 1 plus that), drawn by one generator on
    the device in one call and handed out as views of that buffer. Program
    and reference both read these values."""
    shapes = vision_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(inputs.stream(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=SERVED)
    flat.mul_(SCALE)
    sd = {}
    for (key, shape), part in zip(shapes.items(),
                                  torch.split(flat, sizes)):
        sd[key] = part.view(shape)
        if key.endswith(("norm.weight", "norm1.weight", "norm2.weight")):
            sd[key].add_(1.0)
    return sd


def frame_pool(traffic: dict, cfg: dict, seed: int) -> np.ndarray:
    """[pool, H, W, 3] uint8 frames on the host, uniform over 0..255."""
    rng = np.random.default_rng(inputs.stream(seed, "frames"))
    size = cfg["image_size"]
    return rng.integers(0, 256, (traffic["frame_pool"], size, size, 3),
                        dtype=np.uint8)


def uint8_front_end(cfg: dict) -> bool:
    return bool(cfg["flags"].get("uint8_input", False))


def program_pool(pool: np.ndarray, cfg: dict) -> np.ndarray:
    """The pool as the program takes it: the uint8 frames themselves, or
    without the uint8 front end CLIP's normalised float32 pixels."""
    if uint8_front_end(cfg):
        return pool
    return normalise(torch.from_numpy(pool)).numpy()


def video_batches(pool: np.ndarray, offset: int, n: int, batch: int):
    """(frames [batch, H, W, 3], real count) over a video's n frames, read
    from the pool from `offset` on; the last batch zero-padded, as
    hirest_tpu_torch/extraction/features.py::iter_video_frame_batches pads
    its decoded frames."""
    for i in range(0, n, batch):
        k = min(batch, n - i)
        imgs = np.zeros((batch,) + pool.shape[1:], pool.dtype)
        np.take(pool, (offset + i + np.arange(k)) % len(pool), axis=0,
                out=imgs[:k])
        yield imgs, k


def frame_indices(offset: int, n: int, pool_size: int) -> np.ndarray:
    """The pool index of each of a video's frames."""
    return (offset + np.arange(n)) % pool_size


def build_apply(cfg: dict, sd: dict, device):
    """The port's `apply(frames [B, H, W, 3]) -> [B, embed_dim] f32` on
    `device`, staged from the state dict `sd` with the configuration's
    flags."""
    from hirest_tpu_torch.config import EvaVisionConfig
    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply

    vcfg = EvaVisionConfig(**{k: cfg[k] for k in EVA_FIELDS})
    return build_scanned_vision_apply(sd, vcfg, dtype=torch.bfloat16,
                                      device=device, **cfg["flags"])


def reference_apply(cfg: dict, sd: dict, qmax: Optional[int], device):
    """The plain reference in the program's place: the same batches in, its
    unit features out (the qmax control)."""
    ref = Reference(sd, cfg, qmax=qmax)
    u8 = uint8_front_end(cfg)

    def apply(imgs) -> torch.Tensor:
        x = torch.as_tensor(imgs).to(device)
        return ref.features(x) if u8 else ref.features_of_pixels(x)

    return apply


@dataclass
class Video(Request):
    """One finished video: its frames (`n`), its turnaround (`seconds`),
    where it read the pool, and its features as the host got them."""
    offset: int = 0
    feats: Optional[np.ndarray] = None


def extract(apply, pool: np.ndarray, plan, batch: int, seconds: float,
            tracer) -> Window:
    """The extraction loop of hirest_tpu_torch/extraction/features.py::
    extract_video_features without the JPEG decode: each video's frames in
    batches of `batch` (the last zero-padded), handed over by the port's
    prefetch thread, each through `apply(frames)[:n]`, each video ending in
    the port's finish_video_features (a host fetch, L2 normalisation and
    the cut to the video's duration). Videos come from `plan`, (frames,
    pool offset, seconds) each, until the first one that finishes
    `seconds` after the start."""
    from hirest_tpu_torch.data.prefetch import prefetch
    from hirest_tpu_torch.extraction.features import finish_video_features

    win = Window(start=time.perf_counter())
    deadline = win.start + seconds
    for n, offset, duration in plan:
        t0 = time.perf_counter()
        with tracer.span("video"):
            embs = []
            batches = prefetch(video_batches(pool, offset, n, batch))
            while True:
                with tracer.span("handoff"):
                    item = next(batches, None)
                if item is None:
                    break
                imgs, k = item
                with tracer.span("apply"):
                    embs.append(apply(imgs)[:k])
                win.steps += 1
            with tracer.span("finish"):
                feats = finish_video_features(embs, True, duration)
        t1 = time.perf_counter()
        win.requests.append(Video(n, t1 - t0, offset, feats))
        if t1 >= deadline:
            win.end = t1
            break
    return win


class System:
    """Set-up: the weights on the card and the frame pool on the host from
    the seed, the port's tower staged with the configuration's flags (or
    the configuration's control in its place) and the cell's one batch
    shape warmed twice through the loop."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 control: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.batch = traffic["batch"]
        cfg_run = cfg
        if control:
            ctl = cfg["check"]["control"]
            cfg_run = dict(cfg, flags=ctl.get("flags", cfg["flags"]))
        sd = make_weights(cfg, seed, device)
        self.pool = frame_pool(traffic, cfg, seed)
        self.feed = program_pool(self.pool, cfg_run)
        if control and "qmax" in cfg["check"]["control"]:
            self.apply = reference_apply(cfg, sd, ctl["qmax"], device)
        else:
            self.apply = build_apply(cfg_run, sd, device)
        del sd
        self._warm_up()
        self.plan = inputs.videos(traffic, seed)

    def _warm_up(self) -> None:
        from portbench.trace import Tracer

        for _ in range(2):
            extract(self.apply, self.feed, iter([(self.batch, 0, self.batch)]),
                    self.batch, 0.0, Tracer(False))

    def run(self, seconds: float, tracer) -> Window:
        return extract(self.apply, self.feed, self.plan, self.batch, seconds,
                       tracer)

    def release(self) -> None:
        self.apply = None

    def check(self, window: Window):
        from portbench.systems import eva_extract_check

        return eva_extract_check.verdict(window.requests, self.pool,
                                         self.cfg, self.seed, self.device)
