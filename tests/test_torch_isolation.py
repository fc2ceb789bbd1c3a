"""The port stands alone: every hirest_tpu_torch module imports and tiny
forwards (the scanned tower in each kernel flag configuration, unrolled,
text, and one `analyze` request through the serving engine) run with jax
and flax blocked, without loading any hirest_tpu module; its entry points
(the encoder, the factory, the serving engine and its server) refuse to
fall back to the CPU on their own; and chip_smoke.py refuses to report
success where there is no GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hirest_tpu_torch.config import HirestConfig
from hirest_tpu_torch.extraction.features import make_eva_encoder
from hirest_tpu_torch.models.eva_clip import build_eva_model_and_transforms
from hirest_tpu_torch.serve import ServingEngine
from hirest_tpu_torch.train.trainer import Trainer
from hirest_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]

_ISOLATED = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import hirest_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hirest_tpu_torch.__path__,
                                               "hirest_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from hirest_tpu_torch.config import EvaTextConfig, EvaVisionConfig
from hirest_tpu_torch.models.eva_clip import build_eva_model_and_transforms
from hirest_tpu_torch.serve import ServingEngine
from hirest_tpu_torch.train.trainer import Trainer
from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
from hirest_tpu_torch.utils.init import random_eva_vision_state_dict
cfg = EvaVisionConfig(image_size=28, layers=2, width=128, head_width=32,
                      mlp_ratio=4.0, patch_size=14, embed_dim=32)
sd = random_eva_vision_state_dict(cfg)
# the defaults (v1), then each kernel flag configuration of the ladder,
# the production int8 one last
flag_sets = [{}, dict(attn_v2=True), dict(attn_v3=True, fused_ln=True),
             dict(int8=True), dict(int8=True, fused_quant=True),
             dict(int8=True, fused_quant=True, attn_v2=True),
             dict(int8=True, fused_quant=True, attn_v3=True, fused_mlp=True)]
outs = [build_scanned_vision_apply(sd, cfg, device="cpu", **flags)(
            np.zeros((2, 28, 28, 3))) for flags in flag_sets]
tcfg = EvaTextConfig(context_length=8, vocab_size=50, width=32, heads=2,
                     layers=1, embed_dim=32)
model, _ = build_eva_model_and_transforms(text_config=tcfg,
                                          vision_config=cfg, scan=False,
                                          device="cpu")
outs += [model.encode_image(np.zeros((2, 28, 28, 3))),
         model.encode_text(np.array([[3, 49, 0, 0, 0, 0, 0, 0]] * 2))]
import pathlib, shutil, tempfile
from hirest_tpu_torch.config import (DecoderConfig, HirestConfig,
                                     JointModelConfig, VisualEncoderConfig)
from hirest_tpu_torch.serve import ServingEngine
from hirest_tpu_torch.train.trainer import Trainer
tmp = pathlib.Path(tempfile.mkdtemp())
np.save(tmp / "v.mp4.npy",
        np.random.default_rng(0).normal(size=(30, 1024)).astype(np.float32))
joint = JointModelConfig(
    embed_dim=32,
    visual=VisualEncoderConfig(hidden_size=32, num_hidden_layers=1,
                               num_attention_heads=4, intermediate_size=64),
    decoder=DecoderConfig(vocab_size=40, hidden_size=32, num_decoder_layers=1,
                          num_attention_heads=4, intermediate_size=64,
                          max_target_embeddings=32))
run = HirestConfig(video_feature_dir=str(tmp), device="cpu", num_beams=2,
                   max_words=4, moment_segmentation_max_iterations=2,
                   frame_buckets=(64,), pretrained_dir=str(tmp / "none"))
trainer = Trainer(run, text_encoder_fn=lambda ids: np.ones((len(ids), 1024),
                                                           np.float32),
                  verbose=False, model_config=joint)
analysis = ServingEngine(run, trainer=trainer).analyze("make pancakes",
                                                       "v.mp4")
shutil.rmtree(tmp)
loaded = [m for m in sys.modules
          if m == "hirest_tpu" or m.startswith("hirest_tpu.")]
print(json.dumps({"modules": names,
                  "shapes": [list(o.shape) for o in outs],
                  "finite": all(bool(o.isfinite().all()) for o in outs),
                  "analysis": sorted(analysis),
                  "loaded": loaded}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_and_runs_without_jax():
    r = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert got["shapes"] == [[2, 32]] * 9 and got["finite"]
    for mod in ("hirest_tpu_torch.ops.attention", "hirest_tpu_torch.ops.build",
                "hirest_tpu_torch.ops.quant",
                "hirest_tpu_torch.models.eva_clip",
                "hirest_tpu_torch.models.eva_pad",
                "hirest_tpu_torch.models.eva_scan",
                "hirest_tpu_torch.extraction.features",
                "hirest_tpu_torch.data.prefetch",
                "hirest_tpu_torch.config", "hirest_tpu_torch.timeline",
                "hirest_tpu_torch.native", "hirest_tpu_torch.data.srt",
                "hirest_tpu_torch.data.features",
                "hirest_tpu_torch.data.annotations",
                "hirest_tpu_torch.data.batching",
                "hirest_tpu_torch.tokenizers.bpe",
                "hirest_tpu_torch.tokenizers.wordpiece",
                "hirest_tpu_torch.models.layers",
                "hirest_tpu_torch.models.caption",
                "hirest_tpu_torch.models.joint",
                "hirest_tpu_torch.models.convert",
                "hirest_tpu_torch.infer.segmentation",
                "hirest_tpu_torch.infer.beam",
                "hirest_tpu_torch.infer.retrieval",
                "hirest_tpu_torch.extraction.frames",
                "hirest_tpu_torch.train.trainer",
                "hirest_tpu_torch.serve.engine",
                "hirest_tpu_torch.serve.server",
                "hirest_tpu_torch.serve.__main__"):
        assert mod in got["modules"]
    assert got["analysis"] == ["moment_bounds", "prompt", "steps", "video"]


def test_resolve_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


@pytest.mark.parametrize("int8", [False, True])
def test_encoder_refuses_cpu_fallback(monkeypatch, tmp_path, int8):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eva_encoder(str(tmp_path), int8=int8)


@pytest.mark.parametrize("scan", [True, False])
def test_factory_refuses_cpu_fallback(monkeypatch, scan):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_eva_model_and_transforms(scan=scan)


def test_engine_refuses_cpu_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(HirestConfig(video_feature_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(HirestConfig(video_feature_dir=str(tmp_path)))


def test_serve_cli_refuses_cpu_fallback(tmp_path):
    """`python -m hirest_tpu_torch.serve` with no GPU visible raises unless
    it is given --device cpu; --load takes only a .pth."""
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "hirest_tpu_torch.serve",
           "--video_feature_dir", str(tmp_path), "--no_warmup"]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    r = subprocess.run(cmd + ["--device", "cpu", "--load", "ckpt.msgpack"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 2 and ".pth" in r.stderr


def test_chip_smoke_fails_without_gpu():
    """Where torch sees no GPU, chip_smoke.py exits non-zero and prints no
    result line. A host with a GPU runs it for real instead."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
