"""The port's evaluation CLI (`python -m hirest_tpu_torch.evaluate`,
hirest_tpu_torch/eval/cli.py) and zero-shot retrieval CLI (`python -m
hirest_tpu_torch.inference_video_retrieval`) against the JAX package's
(hirest_tpu.eval.cli.main and the root inference_video_retrieval.py), run
on the CPU in one working directory with one `./pretrained_weights`: a
seeded full-width ViT-B/32 checkpoint (written once for this module), a
MiniLM-L6 BERTScore checkpoint and a small NLI cross-encoder saved as
model.safetensors. Host metrics equal, model-backed scores and retrieval
scores within 1e-5, entailment counts equal. Also `clip_g` through
`run_video_retrieval` on tiny shared EVA weights."""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (TEXT_TINY, TINY224, eva_state_dict, jax_params,
                             jax_text_params, text_state_dict, write_split)

import hirest_tpu.config as jax_config
import hirest_tpu.eval.cli as jax_cli
import hirest_tpu.infer.retrieval as jax_retrieval
from hirest_tpu.eval.make_gt import build_formatted_gt
from hirest_tpu.models.eva_clip import EvaTextTower as FlaxEvaTextTower
from hirest_tpu.models.eva_clip import EvaVisionTower as FlaxEvaVisionTower
from hirest_tpu.models.eva_clip import preprocess_image as jax_preprocess
from hirest_tpu_torch import inference_video_retrieval as port_vr
from hirest_tpu_torch.config import EvaTextConfig, EvaVisionConfig
from hirest_tpu_torch.config import HirestConfig
from hirest_tpu_torch.eval import cli
from hirest_tpu_torch.infer.retrieval import run_video_retrieval
from hirest_tpu_torch.models.eva_clip import (build_unrolled_vision_apply,
                                              eva_text_encoder,
                                              preprocess_image)
from hirest_tpu_torch.models.minilm import MiniLmConfig
from hirest_tpu_torch.utils.init import (random_clip_state_dict,
                                         random_minilm_state_dict,
                                         random_nli_state_dict)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
MODEL_SCORES = ("CLIPScore", "BERTScore_F1")
NLI_SPEC = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=128)
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "add", "salt", "mix",
         "water", "and", "oat", "##meal", "pan", "##cake", "make", "the"]


def _tensors(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The working directory: ./pretrained_weights, ./data (a seeded split,
    its formatted GT, negatives), frames, [n, 512] features for `clip`,
    and predictions for the four tasks."""
    root = tmp_path_factory.mktemp("ws")
    pre = root / "pretrained_weights"
    (pre / "nli").mkdir(parents=True)
    torch.save(_tensors(random_clip_state_dict(seed=0)), pre / "ViT-B-32.pt")
    vocab = "\n".join(WORDS + [f"w{i}" for i in range(104)]) + "\n"
    (pre / "vocab.txt").write_text(vocab)
    torch.save(_tensors(random_minilm_state_dict(MiniLmConfig(), seed=1)),
               pre / "all-MiniLM-L6-v2.bin")
    nli_sd = random_nli_state_dict(MiniLmConfig(**NLI_SPEC), seed=2)
    for k in nli_sd:  # a head sharp enough for labels that differ
        if k.startswith(("classifier", "bert.pooler")):
            nli_sd[k] = nli_sd[k] * np.float32(100.0)
    from safetensors.numpy import save_file

    save_file(nli_sd, str(pre / "nli" / "model.safetensors"))
    (pre / "nli" / "vocab.txt").write_text(vocab)
    (pre / "nli" / "config.json").write_text(json.dumps({
        "model_type": "bert", "type_vocab_size": 2, "layer_norm_eps": 1e-12,
        "id2label": {"0": "contradiction", "1": "neutral",
                     "2": "entailment"}, **NLI_SPEC}))

    data, _, _ = write_split(root / "d", n_videos=2)
    splits = root / "data" / "splits"
    (root / "data" / "evaluation").mkdir(parents=True)
    splits.mkdir(parents=True)
    test = json.loads((data / "all_data_test.json").read_text())
    (splits / "all_data_test.json").write_text(json.dumps(test))
    neg = json.loads((data / "all_data_val.json").read_text())
    (splits / "all_data_test_negative_samples.json").write_text(
        json.dumps(neg))
    gt = build_formatted_gt(test)
    (root / "data" / "evaluation" /
     "formatted_moment_evaluation_gt.json").write_text(json.dumps(gt))

    from PIL import Image

    rng = np.random.default_rng(3)
    feats = root / "feats512"
    feats.mkdir()
    for split in (test, neg):
        for p in split:
            for vid, ann in split[p].items():
                n = round(ann["v_duration"])
                d = root / "frames" / vid
                d.mkdir(parents=True)
                for i in range(1, n + 1):
                    Image.fromarray(rng.integers(0, 256, (40, 48, 3),
                                                 dtype=np.uint8)).save(
                        d / f"frame_{i:04d}.jpg", quality=90)
                np.save(feats / f"{vid}.npy",
                        rng.normal(size=(n, 512)).astype(np.float32))

    preds = root / "preds"
    preds.mkdir()
    mr = {p: {v: {"bounds": (np.asarray(a["bounds"]) + rng.integers(
        -4, 5, 2)).tolist()} for v, a in test[p].items()} for p in test}
    ms = {v: {"bounds": (np.asarray(g["bounds"]) + rng.integers(
        -3, 4, (len(g["bounds"]), 2))).tolist()} for v, g in gt.items()}
    heads = [c["sentence"] for g in gt.values() for c in g["captions"]]
    sc = {v: {"captions": [{"sentence": heads[int(rng.integers(len(heads)))]}
                           for _ in g["captions"]]} for v, g in gt.items()}
    for name, obj in (("mr", mr), ("ms", ms), ("sc", sc)):
        (preds / f"{name}.json").write_text(json.dumps(obj))
    return root


def _root_retrieval_main():
    spec = importlib.util.spec_from_file_location(
        "root_inference_video_retrieval",
        REPO / "inference_video_retrieval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _vr_close(got: dict, want: dict, tol: float = TOL):
    assert list(got) == list(want)
    for p in want:
        assert got[p]["videos"] == want[p]["videos"]
        np.testing.assert_allclose(got[p]["scores"], want[p]["scores"],
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("raw_frame", [False, True])
def test_retrieval_cli_clip_matches_jax(ws, monkeypatch, raw_frame):
    """`--video_retrieval_model clip` in f32, from features and from
    frames: the VR_results JSON of the root script's main and of the
    port's, the same prompts, videos and scores within 1e-5."""
    monkeypatch.chdir(ws)
    args = ["--data_dir", "data/splits", "--video_retrieval_model", "clip",
            "--pretrained_dir", "pretrained_weights", "--run_name",
            f"clip_{raw_frame}", "--video_feature_dir", "feats512"]
    if raw_frame:
        args += ["--raw_frame", "--video_dir", "frames", "--n_model_frames",
                 "4", "--eval_batch_size", "4"]
    else:
        args += ["--n_model_frames", "8"]
    monkeypatch.setattr(sys, "argv", ["inference_video_retrieval.py", *args,
                                      "--device", "cpu"])
    _root_retrieval_main()()
    want = json.loads(Path(f"VR_results/clip_{raw_frame}.json").read_text())
    got = port_vr.main(args + ["--device", "cpu"])
    assert json.loads(Path(f"VR_results/clip_{raw_frame}.json").read_text()
                      ) == got
    _vr_close(got, want)
    assert len(got) == 2 and len(got["make pancakes"]["videos"]) == 8


def test_retrieval_cli_clip_bf16(ws, monkeypatch):
    """--fp16 runs the towers in bf16: scores (cosines) within 2^-7 of the
    port's own f32 run."""
    monkeypatch.chdir(ws)
    args = ["--data_dir", "data/splits", "--video_retrieval_model", "clip",
            "--pretrained_dir", "pretrained_weights", "--raw_frame",
            "--video_dir", "frames", "--n_model_frames", "2",
            "--video_feature_dir", "feats512", "--device", "cpu"]
    f32 = port_vr.main(args + ["--run_name", "f32"])
    bf16 = port_vr.main(args + ["--run_name", "bf16", "--fp16"])
    _vr_close(bf16, f32, 2 ** -7)


def test_clip_g_run_video_retrieval_matches_jax(ws, monkeypatch, tmp_path):
    """`clip_g`'s flow through run_video_retrieval on tiny shared EVA
    weights (TEXT_TINY's text tower over the CLIP tokenizer's 77 x 49408
    ids, the unrolled vision tower at 224 px), from frames and from
    features, against the JAX function with the flax towers the root
    script builds."""
    monkeypatch.chdir(tmp_path)
    data = ws / "data" / "splits"
    spec = dict(TEXT_TINY, context_length=77, vocab_size=49408)
    tsd, vsd = text_state_dict(spec), eva_state_dict(TINY224)
    text = eva_text_encoder({f"text.{k}": v for k, v in tsd.items()},
                            EvaTextConfig(**spec), torch.float32,
                            torch.device("cpu"))
    image = build_unrolled_vision_apply(vsd, EvaVisionConfig(**TINY224),
                                        dtype=torch.float32, device="cpu")
    jt = FlaxEvaTextTower(jax_config.EvaTextConfig(**spec))
    jv = FlaxEvaVisionTower(jax_config.EvaVisionConfig(**TINY224))
    jtp, jvp = jax_text_params(tsd, spec), jax_params(vsd, TINY224)
    feats = tmp_path / "feats"
    feats.mkdir()
    rng = np.random.default_rng(4)
    for f in (ws / "feats512").glob("*.npy"):
        np.save(feats / f.name, rng.normal(size=(20, 32)).astype(np.float32))
    for raw in (True, False):
        kw = dict(data_dir=str(data), video_feature_dir=str(feats),
                  raw_frame=raw, video_dir=str(ws / "frames"),
                  n_model_frames=3, eval_batch_size=2,
                  run_name=f"clip_g_{raw}")
        got = run_video_retrieval(HirestConfig(device="cpu", **kw), text,
                                  image, preprocess_image if raw else None)
        want = jax_retrieval.run_video_retrieval(
            jax_config.HirestConfig(**kw),
            lambda ids: jt.apply(jtp, jnp.asarray(ids)),
            lambda im: jv.apply(jvp, jnp.asarray(im)),
            jax_preprocess if raw else None)
        _vr_close(got, want)


def _eval_both(ws, monkeypatch, argv):
    monkeypatch.chdir(ws)
    want = jax_cli.main(list(argv))
    got = cli.main(list(argv) + ["--device", "cpu"])
    return got, want


def test_eval_cli_video_retrieval_matches_jax(ws, monkeypatch):
    monkeypatch.chdir(ws)
    args = ["--data_dir", "data/splits", "--video_retrieval_model", "clip",
            "--pretrained_dir", "pretrained_weights", "--video_feature_dir",
            "feats512", "--n_model_frames", "8", "--run_name", "vr_eval",
            "--device", "cpu"]
    port_vr.main(args)
    got, want = _eval_both(ws, monkeypatch, [
        "--task", "video_retrieval", "--pred_data", "VR_results/vr_eval.json",
        "--data_root", "data"])
    assert got == want and got["all"]["total_prompt_count"] == 2


@pytest.mark.parametrize("task,extra", [
    ("moment_retrieval", []),
    ("moment_segmentation", []),
    ("moment_segmentation", ["--preprocess_moment_bounds"]),
    ("moment_segmentation", ["--print_per_category"])])
def test_eval_cli_moments_match_jax(ws, monkeypatch, task, extra):
    pred = "preds/mr.json" if task == "moment_retrieval" else "preds/ms.json"
    got, want = _eval_both(ws, monkeypatch, ["--task", task, "--pred_data",
                                             pred, "--data_root", "data",
                                             *extra])
    assert got == want and got["all"]


def test_eval_cli_step_captioning_matches_jax(ws, monkeypatch):
    """Step captioning with CLIPScore (ViT-B/32 on --frame_dir), BERTScore
    (MiniLM-L6) and the NLI cross-encoder (model.safetensors): the COCO
    metrics and the entailment shares equal, CLIPScore and BERTScore within
    1e-5."""
    got, want = _eval_both(ws, monkeypatch, [
        "--task", "step_captioning", "--pred_data", "preds/sc.json",
        "--data_root", "data", "--frame_dir", "frames"])
    g, w = got["all"], want["all"]
    assert set(g) == set(w)
    for k in MODEL_SCORES:
        assert abs(g[k] - w[k]) <= TOL, (k, g[k], w[k])
    assert {k: v for k, v in g.items() if k not in MODEL_SCORES} == \
        {k: v for k, v in w.items() if k not in MODEL_SCORES}
    assert {"CLIPScore", "BERTScore_F1", "Entailment", "METEOR"} <= set(g)
    assert g["CLIPScore"] != 0


@pytest.mark.parametrize("spec,want", [
    ("cuda", "cuda"), ("cpu", "cpu"), ("cuda:1", "cuda:1"), ("0", "cuda:0"),
    ("3", "cuda:3"), ("-1", "cpu")])
def test_eval_cli_device_flag(spec, want):
    assert cli.parse_device(spec) == want


def test_eval_cli_device_flag_rejects():
    with pytest.raises(ValueError):
        cli.parse_device("-2")
    args = cli.get_eval_parser().parse_args(["--task", "x", "--pred_data",
                                             "p"])
    assert args.device == "cuda"
