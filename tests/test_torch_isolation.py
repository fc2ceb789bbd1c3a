"""The port stands alone: every hirest_tpu_torch module imports and tiny
forwards (the scanned tower in each kernel flag configuration, unrolled,
text) run with jax and flax blocked,
without loading any hirest_tpu module; its entry points refuse to fall back
to the CPU on their own; and chip_smoke.py refuses to report success where
there is no GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hirest_tpu_torch.extraction.features import make_eva_encoder
from hirest_tpu_torch.models.eva_clip import build_eva_model_and_transforms
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
loaded = [m for m in sys.modules
          if m == "hirest_tpu" or m.startswith("hirest_tpu.")]
print(json.dumps({"modules": names,
                  "shapes": [list(o.shape) for o in outs],
                  "finite": all(bool(o.isfinite().all()) for o in outs),
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
                "hirest_tpu_torch.data.prefetch"):
        assert mod in got["modules"]


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
