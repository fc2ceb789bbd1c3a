"""The port stands alone: every hirest_tpu_torch module imports and tiny
forwards (the scanned tower in each kernel flag configuration, unrolled,
text, one `analyze` request through the serving engine, a Whisper
transcription under the decoding rules, MiniLM, the CLIP text and vision
towers, the ResNet tower, the NLI cross-encoder, the eval metrics, a
one-rank mesh with its batch sharding and object gather) run with jax and
flax blocked, without loading any hirest_tpu module; its entry points (the
encoder, the factory, the unrolled int8 tower, the serving engine and its
server, the run CLI, the Whisper transcriber, the MiniLM embedder, the ASR
and custom-video CLIs, the CLIP towers, the scorers, the evaluation and
retrieval CLIs, a mesh's ranks and the bench) refuse to fall back to the
CPU on their own; and chip_smoke.py refuses to report success where there
is no GPU."""

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
from hirest_tpu_torch.models.eva_quant import build_int8_vision_apply
from hirest_tpu_torch.serve import ServingEngine
from hirest_tpu_torch.train.trainer import Trainer
from hirest_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]

_ISOLATED = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import torch
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
from hirest_tpu_torch.extraction.whisper_decode import (DecodeOptions,
    TorchWhisperAdapter, transcribe_with_rules)
from hirest_tpu_torch.models.minilm import MiniLmConfig, load_minilm
from hirest_tpu_torch.models.whisper import WhisperConfig, load_whisper
from hirest_tpu_torch.utils.init import (random_minilm_state_dict,
                                         random_whisper_state_dict)
wcfg = WhisperConfig(d_model=32, encoder_layers=1, decoder_layers=1, heads=2,
                     ffn_dim=64)
enc, dec = load_whisper(random_whisper_state_dict(wcfg), wcfg, "cpu")
class Tok:  # the .en special ids, text as the ids themselves
    EOT, SOT, TRANSLATE, TRANSCRIBE, SOT_LM = 50256, 50257, 50357, 50358, 50359
    SOT_PREV, NO_SPEECH, NO_TIMESTAMPS = 50360, 50361, 50362
    TIMESTAMP_BEGIN = 50363
    encode = lambda self, text: [32] * len(text)
    decode = lambda self, ids: ",".join(map(str, ids))
    non_speech_tokens = lambda self: [5]
asr_out = transcribe_with_rules(
    TorchWhisperAdapter(enc, dec), np.zeros(32000, np.float32), Tok(),
    DecodeOptions(sample_len=4, temperature=(0.5,), best_of=2,
                  logprob_threshold=None, no_speech_threshold=None))
mcfg = MiniLmConfig(vocab_size=50, hidden_size=32, num_hidden_layers=1,
                    num_attention_heads=4, intermediate_size=64)
outs.append(load_minilm(random_minilm_state_dict(mcfg), mcfg, "cpu")(
    torch.ones((2, 5), dtype=torch.long), torch.ones((2, 5))))
from hirest_tpu_torch.models.clip_resnet import (ClipResNetConfig,
                                                 ClipResNetTower)
from hirest_tpu_torch.models.nli import load_nli
from hirest_tpu_torch.models.openai_clip import (ClipVisionConfig,
                                                 load_clip_towers)
from hirest_tpu_torch.utils.init import (random_clip_state_dict,
                                         random_nli_state_dict)
from hirest_tpu_torch.eval.metrics import evaluate_video_retrieval
ccfg = ClipVisionConfig(image_size=64, layers=1, width=64, heads=1,
                        patch_size=32, embed_dim=32)
ctext = EvaTextConfig(context_length=8, vocab_size=50, width=64, heads=1,
                      layers=1, embed_dim=32)
ctower, vtower = load_clip_towers(random_clip_state_dict(ctext, ccfg),
                                  device="cpu", text_cfg=ctext,
                                  vision_cfg=ccfg)
outs += [ctower(torch.tensor([[3, 49, 0, 0, 0, 0, 0, 0]] * 2)),
         vtower(torch.zeros(2, 64, 64, 3)),
         ClipResNetTower(ClipResNetConfig(layers=(1, 1, 1, 1), output_dim=32,
                                          heads=2, image_size=64,
                                          width=16)).eval()(
             torch.zeros(2, 64, 64, 3))[:, :32]]
nli_logits = load_nli(random_nli_state_dict(mcfg), mcfg, 3, "cpu")(
    torch.ones((2, 5), dtype=torch.long), torch.ones((2, 5)),
    torch.zeros((2, 5), dtype=torch.long))
vr = evaluate_video_retrieval({"p": {"v.mp4": {}}}, {"p": {
    "videos": ["v.mp4", "w.mp4"], "scores": [0.9, 0.1]}})
shutil.rmtree(tmp)
from hirest_tpu_torch.parallel import make_mesh, shard_batch
from hirest_tpu_torch.parallel.collectives import allgather_objects
mesh = make_mesh("data:1")
sharded = shard_batch({"x": np.zeros((4, 2)), "names": ["a"]}, mesh)
parallel = [list(sharded["x"].shape), allgather_objects({"k": (1,)})]
loaded = [m for m in sys.modules
          if m == "hirest_tpu" or m.startswith("hirest_tpu.")]
print(json.dumps({"modules": names,
                  "shapes": [list(o.shape) for o in outs],
                  "finite": all(bool(o.isfinite().all()) for o in outs),
                  "analysis": sorted(analysis),
                  "segments": len(asr_out["segments"]),
                  "nli": list(nli_logits.shape), "vr": vr["all"]["R@1"],
                  "parallel": parallel, "loaded": loaded}))
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
    assert got["shapes"] == [[2, 32]] * 13 and got["finite"]
    assert got["segments"] >= 1
    assert got["nli"] == [2, 3] and got["vr"] == 100.0
    assert got["parallel"] == [[4, 2], [{"k": [1]}]]
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
                "hirest_tpu_torch.serve.__main__",
                "hirest_tpu_torch.models.eva_quant",
                "hirest_tpu_torch.data.multitask",
                "hirest_tpu_torch.train.losses",
                "hirest_tpu_torch.train.optim",
                "hirest_tpu_torch.train.formatting",
                "hirest_tpu_torch.train.contrastive",
                "hirest_tpu_torch.train.pretrain",
                "hirest_tpu_torch.utils.meters",
                "hirest_tpu_torch.utils.profiling",
                "hirest_tpu_torch.infer.pipeline",
                "hirest_tpu_torch.run",
                "hirest_tpu_torch.tokenizers.gpt2_bpe",
                "hirest_tpu_torch.extraction.mel",
                "hirest_tpu_torch.extraction.audio",
                "hirest_tpu_torch.extraction.whisper_decode",
                "hirest_tpu_torch.extraction.asr",
                "hirest_tpu_torch.models.whisper",
                "hirest_tpu_torch.models.minilm",
                "hirest_tpu_torch.infer.custom_video",
                "hirest_tpu_torch.pipeline_custom_video",
                "hirest_tpu_torch.eval.metrics", "hirest_tpu_torch.eval.coco",
                "hirest_tpu_torch.eval.meteor",
                "hirest_tpu_torch.eval.captions",
                "hirest_tpu_torch.eval.make_gt",
                "hirest_tpu_torch.eval.bertscore",
                "hirest_tpu_torch.eval.cli", "hirest_tpu_torch.evaluate",
                "hirest_tpu_torch.models.openai_clip",
                "hirest_tpu_torch.models.clip_resnet",
                "hirest_tpu_torch.models.nli",
                "hirest_tpu_torch.inference_video_retrieval",
                "hirest_tpu_torch.extraction.download",
                "hirest_tpu_torch.parallel",
                "hirest_tpu_torch.parallel.mesh",
                "hirest_tpu_torch.parallel.collectives",
                "hirest_tpu_torch.parallel.tp", "hirest_tpu_torch.bench"):
        assert mod in got["modules"]
    assert got["analysis"] == ["moment_bounds", "prompt", "steps", "video"]


def test_mesh_ranks_refuse_cpu_fallback(monkeypatch):
    """init_distributed binds a rank to its GPU or raises; only an explicit
    "cpu" runs on the CPU (one rank here: no group is made)."""
    from hirest_tpu_torch.parallel.mesh import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed(device=device, rank=0, world_size=1)
    assert init_distributed(device="cpu", rank=0,
                            world_size=1) == torch.device("cpu")


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


def test_int8_tower_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_int8_vision_apply({}, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_int8_vision_apply({})


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


def test_run_cli_refuses_cpu_fallback(tmp_path):
    """`python -m hirest_tpu_torch.run` with no GPU visible raises unless it
    is given --device cpu."""
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "hirest_tpu_torch.run",
                        "--train", "--task_moment_retrieval",
                        "--data_dir", str(tmp_path),
                        "--video_feature_dir", str(tmp_path),
                        "--ckpt_dir", str(tmp_path / "ckpt"),
                        "--pretrained_dir", str(tmp_path / "none")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "ckpt").exists()


@pytest.mark.parametrize("mode", [["--bf16"], ["--latency"]],
                         ids=["bf16", "latency"])
def test_bench_refuses_cpu_fallback(mode):
    """`python -m hirest_tpu_torch.bench` with no GPU visible prints one
    zero-value JSON line naming the missing CUDA device and exits 1: it
    times nothing on the CPU (only --cpu-smoke runs there, untimed). In a
    process of its own: the fail-fast ends the interpreter."""
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "hirest_tpu_torch.bench",
                        *mode], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 1, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] == 0.0 and "no CUDA device" in line["error"]


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


def test_asr_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    from hirest_tpu_torch.extraction.asr import (TorchWhisperTranscriber,
                                                 embed_srt_dir)
    from hirest_tpu_torch.models.minilm import make_minilm_embedder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchWhisperTranscriber({}, decode_text_fn=str)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_minilm_embedder({}, str(tmp_path / "vocab.txt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        embed_srt_dir(str(tmp_path), str(tmp_path / "out"),
                      pretrained_dir=str(tmp_path))


@pytest.mark.parametrize("cli", [
    ["hirest_tpu_torch.extraction.asr", "--audio_dir", "{t}",
     "--asr_dir", "{t}/srt", "--ckpt", "{t}/whisper.bin"],
    ["hirest_tpu_torch.extraction.asr", "--embed", "--asr_dir", "{t}",
     "--save_dir", "{t}/emb", "--pretrained_dir", "{t}"],
    ["hirest_tpu_torch.pipeline_custom_video", "--video", "{t}/v.mp4",
     "--prompt", "make pancakes", "--work_dir", "{t}/work"]])
def test_asr_and_custom_video_clis_refuse_cpu_fallback(tmp_path, cli):
    """`python -m hirest_tpu_torch.extraction.asr` (transcription with the
    port's Whisper, and --embed) and `python -m
    hirest_tpu_torch.pipeline_custom_video` with no GPU visible raise
    before any work unless given --device cpu."""
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    args = [a.format(t=tmp_path) for a in cli]
    r = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not any(p.name in ("srt", "emb", "work")
                   for p in tmp_path.iterdir())
    r = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "no CUDA device" not in r.stderr


def test_clip_and_scorers_refuse_cpu_fallback(monkeypatch, tmp_path):
    from hirest_tpu_torch.eval.bertscore import make_bertscore_fn
    from hirest_tpu_torch.models.nli import make_nli_entailment_fn
    from hirest_tpu_torch.models.openai_clip import (
        build_clip_from_state_dict, load_clip_towers)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: load_clip_towers({}),
                 lambda: build_clip_from_state_dict({}),
                 lambda: make_bertscore_fn({}, str(tmp_path / "vocab.txt")),
                 lambda: make_nli_entailment_fn(str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("cli", [
    ["hirest_tpu_torch.evaluate", "--task", "video_retrieval",
     "--pred_data", "{t}/missing.json", "--data_root", "{t}"],
    ["hirest_tpu_torch.evaluate", "--task", "video_retrieval",
     "--pred_data", "{t}/missing.json", "--data_root", "{t}",
     "--device", "0"],
    ["hirest_tpu_torch.inference_video_retrieval", "--data_dir", "{t}",
     "--video_feature_dir", "{t}"]])
def test_eval_and_retrieval_clis_refuse_cpu_fallback(tmp_path, cli):
    """`python -m hirest_tpu_torch.evaluate` (--device cuda by default, or
    an integer >= 0) and `python -m hirest_tpu_torch.inference_video_
    retrieval` with no GPU visible raise before any work unless given
    --device cpu (or -1, the reference's spelling, for the evaluator)."""
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    args = [a.format(t=tmp_path) for a in cli]
    r = subprocess.run([sys.executable, "-m", *args], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "VR_results").exists()
    cpu = ["--device", "-1" if "evaluate" in args[0] else "cpu"]
    if "--device" in args:
        args = args[:args.index("--device")]
    r = subprocess.run([sys.executable, "-m", *args, *cpu], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0  # the inputs are missing
    assert "no CUDA device" not in r.stderr
    assert "No such file" in r.stderr or "FileNotFoundError" in r.stderr
