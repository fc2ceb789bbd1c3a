"""The port's evaluation modules against the JAX package's: the host
metrics (hirest_tpu_torch.eval.metrics, coco, meteor in both versions,
captions, make_gt) give equal results on the JAX tests' own inputs and on
a seeded synthetic split; the NLI cross-encoder (models/nli.py) and
BERTScore (eval/bertscore.py) on the same seeded weights within 1e-5
(logits) and 1e-6 (F1); the `.safetensors` reader against the
safetensors package; the download frontend's split walk and its gate."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import write_split

import hirest_tpu.eval.captions as jax_captions
import hirest_tpu.eval.coco as jax_coco
import hirest_tpu.eval.make_gt as jax_make_gt
import hirest_tpu.eval.meteor as jax_meteor
import hirest_tpu.eval.metrics as jax_metrics
import hirest_tpu.extraction.download as jax_download
import hirest_tpu.models.nli as jax_nli
from hirest_tpu.eval.bertscore import bertscore_pairs as jax_bertscore_pairs
from hirest_tpu.eval.bertscore import make_bertscore_fn as jax_bertscore_fn
from hirest_tpu.models.minilm import MiniLmConfig as JaxMiniLmConfig
from hirest_tpu_torch.eval import captions, coco, make_gt, meteor, metrics
from hirest_tpu_torch.eval.bertscore import bertscore_pairs, make_bertscore_fn
from hirest_tpu_torch.extraction import download
from hirest_tpu_torch.models import nli
from hirest_tpu_torch.models.convert import (load_safetensors,
                                             load_torch_ckpt, nli_from_jax,
                                             save_safetensors)
from hirest_tpu_torch.models.minilm import MiniLmConfig
from hirest_tpu_torch.utils.init import (random_minilm_state_dict,
                                         random_nli_state_dict)

# the small BERT of tests/test_nli.py
NLI_SPEC = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64)
MNLI_LABELS = {0: "CONTRADICTION", 1: "NEUTRAL", 2: "ENTAILMENT"}
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "cat", "sat", "dog",
         "ran", "a", "on", "mat", "add", "salt", "mix", "water", "pan"]


# --- the JAX tests' inputs (tests/test_eval_metrics.py, test_eval_coco.py,
# test_meteor.py) and a seeded synthetic split -----------------------------

VR_CASES = {
    "recall": ({"p1": {"v1.mp4": {}}, "p2": {"v9.mp4": {}}},
               {"p1": {"videos": ["v1.mp4", "v2.mp4", "v3.mp4"],
                       "scores": [0.9, 0.5, 0.1]},
                "p2": {"videos": ["v1.mp4", "v2.mp4", "v9.mp4"],
                       "scores": [0.9, 0.5, 0.1]}}, dict(ks=(1, 2, 3))),
    "ties": ({"p": {"a.mp4": {}}},
             {"p": {"videos": ["a.mp4", "z.mp4"], "scores": [0.5, 0.5]}},
             dict(ks=(1,))),
}
MR_GT = {"p": {"v": {"clip": True, "bounds": [10, 20]},
               "w": {"clip": False, "bounds": [0, 5]}}}
MR_PRED = {"p": {"v": {"bounds": [10, 19]}, "w": {"bounds": [99, 100]}}}
SB_CASES = {
    "basic": ({"v": {"bounds": [[0, 10], [10, 20]]}},
              {"v": {"bounds": [[0, 10], [50, 60]]}}),
    "empty rows": ({"v1": {"bounds": [[0, 5], [5, 10]]},
                    "v2": {"bounds": [[0, 4]]}},
                   {"v1": {"bounds": [[0, 5], [5, 10]]},
                    "v2": {"bounds": []}}),
}
PP_CASES = {
    "tiles": ({"v": {"bounds": [[10, 20], [20, 40]]}},
              {"v": {"bounds": [[12, 18], [25, 30], [5, 9], [41, 50]]}}),
    "no valid": ({"v": {"bounds": [[10, 20]]}}, {"v": {"bounds": [[0, 5]]}}),
}
METEOR_CASES = [
    ("the cat sat on the mat", "the cat was sat on the mat"),
    ("preheat the oven to 350 degrees", "heat oven to 350 degrees fahrenheit"),
    ("mix the flour and sugar", "the flour and the sugar are mixed together"),
    ("no overlap whatsoever here", "completely different tokens appear"),
    ("identical sentence", "identical sentence"),
    ("a a a a", "a a"),
    ("running quickly", "run quick"),
    ("slice the onions thinly", "thinly slice the onion"),
    ("", "nonempty reference"),
    ("nonempty hypothesis", ""),
]
CAPTION_GT = {
    "v1.mp4": {"captions": [
        {"sentence": "Add the salt and water", "start": 0, "end": 4},
        {"sentence": "Mix the flour well in the bowl", "start": 4, "end": 8}]},
    "v2.mp4": {"captions": [
        {"sentence": "Heat the pan on the stove", "start": 0, "end": 5}]},
}
CAPTION_PRED = {
    "v1.mp4": {"captions": [{"sentence": "add salt and some water"},
                            {"sentence": "mix flour in a bowl"}]},
    "v2.mp4": {"captions": [{"sentence": "heat a pan"}]},
}


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A seeded split (tests/torch_port_util.write_split, 6 videos a
    prompt), its formatted GT, random VR scores, perturbed moment and step
    bounds, and random captions from its headings."""
    root = tmp_path_factory.mktemp("split")
    data, _, _ = write_split(root, n_videos=6,
                             prompts=("make pancakes", "mix oatmeal",
                                      "boil water"))
    anns = json.loads((data / "all_data_test.json").read_text())
    gt = jax_make_gt.build_formatted_gt(anns)
    rng = np.random.default_rng(0)
    videos = [v for p in anns for v in anns[p]]
    vr = {p: {"videos": videos, "scores": rng.random(len(videos)).tolist()}
          for p in anns}
    mr = {p: {v: {"bounds": (np.asarray(a["bounds"]) + rng.integers(
        -4, 5, 2)).tolist()} for v, a in anns[p].items()} for p in anns}
    sb = {v: {"bounds": (np.asarray(g["bounds"]) + rng.integers(
        -3, 4, (len(g["bounds"]), 2))).tolist()} for v, g in gt.items()}
    heads = [c["sentence"] for g in gt.values() for c in g["captions"]]
    caps = {v: {"captions": [{"sentence": heads[int(rng.integers(
        len(heads)))]} for _ in g["captions"]]} for v, g in gt.items()}
    cats = {"prompt_to_cat": {"make pancakes": "Cooking",
                              "mix oatmeal": "Cooking",
                              "boil water": "Kitchen"}}
    cats["video_to_cat"] = {v: cats["prompt_to_cat"][p]
                            for p in anns for v in anns[p]}
    return dict(anns=anns, gt=gt, vr=vr, mr=mr, sb=sb, caps=caps, cats=cats,
                data=data)


def _both_categories(c):
    return (jax_metrics.Categories(**c), metrics.Categories(**c))


@pytest.mark.parametrize("case", sorted(VR_CASES) + ["synthetic"])
def test_video_retrieval_equal(case, synthetic):
    if case == "synthetic":
        gt, pred, kw = synthetic["anns"], synthetic["vr"], {}
        jc, pc = _both_categories(synthetic["cats"])
    else:
        (gt, pred, kw), jc, pc = VR_CASES[case], None, None
    assert metrics.evaluate_video_retrieval(gt, pred, pc, **kw) == \
        jax_metrics.evaluate_video_retrieval(gt, pred, jc, **kw)


@pytest.mark.parametrize("case", ["basic", "categories", "synthetic"])
def test_moment_retrieval_equal(case, synthetic):
    gt, pred, cats = MR_GT, MR_PRED, None
    if case == "categories":
        cats = {"prompt_to_cat": {"p": "Cooking"},
                "video_to_cat": {"v": "Cooking"}}
    elif case == "synthetic":
        gt, pred, cats = synthetic["anns"], synthetic["mr"], synthetic["cats"]
    jc, pc = _both_categories(cats) if cats else (None, None)
    assert metrics.evaluate_moment_retrieval(gt, pred, pc) == \
        jax_metrics.evaluate_moment_retrieval(gt, pred, jc)


@pytest.mark.parametrize("case", sorted(SB_CASES) + ["synthetic"])
def test_step_bounds_and_preprocess_equal(case, synthetic):
    if case == "synthetic":
        gt, pred = synthetic["gt"], synthetic["sb"]
        jc, pc = _both_categories(synthetic["cats"])
    else:
        (gt, pred), jc, pc = SB_CASES[case], None, None
    assert metrics.compute_step_bound_scores(gt, pred, pc) == \
        jax_metrics.compute_step_bound_scores(gt, pred, jc)
    assert metrics.preprocess_moment_bounds(gt, pred) == \
        jax_metrics.preprocess_moment_bounds(gt, pred)


@pytest.mark.parametrize("case", sorted(PP_CASES))
def test_preprocess_moment_bounds_equal(case):
    gt, pred = PP_CASES[case]
    assert metrics.preprocess_moment_bounds(gt, pred) == \
        jax_metrics.preprocess_moment_bounds(gt, pred)


def test_iou_and_nms_equal():
    rng = np.random.default_rng(1)
    for _ in range(50):
        a, b = np.sort(rng.integers(0, 40, 2)), np.sort(rng.integers(0, 40, 2))
        assert metrics.compute_iou(a, b) == jax_metrics.compute_iou(a, b)
    for iv in (np.array([[0, 10], [1, 9], [20, 30]], float), np.zeros((0, 2)),
               np.sort(rng.integers(0, 100, (30, 2)), 1).astype(float)):
        np.testing.assert_array_equal(metrics.nms_1d(iv),
                                      jax_metrics.nms_1d(iv))


@pytest.mark.parametrize("version", ["1.5", "2005"])
def test_coco_evaluator_equal(version, synthetic):
    cands = [c["sentence"] for v in synthetic["caps"].values()
             for c in v["captions"]] + ["a b c d e", "the cat sat"]
    refs = [c["sentence"] for v in synthetic["gt"].values()
            for c in v["captions"]] + ["a b c d e", "the dog ran"]
    assert coco.CocoEvaluator(meteor_version=version).run_evaluation(
        cands, refs) == jax_coco.CocoEvaluator(
            meteor_version=version).run_evaluation(cands, refs)
    for text in cands + ["Hello, World!  It's  3.5 o'clock..."]:
        assert coco.tokenize(text) == jax_coco.tokenize(text)


def test_meteor_both_versions_equal():
    words = " ".join(h + " " + r for h, r in METEOR_CASES).split()
    words += ["caption", "captioning", "relational", "hopefulness",
              "formaliti", "vietnamization", "sensibiliti", "adjustable"]
    assert [meteor.porter_stem(w) for w in words] == \
        [jax_meteor.porter_stem(w) for w in words]
    hyps = [h.split() for h, _ in METEOR_CASES]
    refs = [[r.split()] for _, r in METEOR_CASES]
    for h, (r,) in zip(hyps, refs):
        assert meteor.meteor_single(h, r) == jax_meteor.meteor_single(h, r)
        assert meteor.meteor_single_15(h, r) == \
            jax_meteor.meteor_single_15(h, r)
        assert meteor.align(h, r) == jax_meteor.align(h, r)
    assert meteor.meteor(hyps, refs) == jax_meteor.meteor(hyps, refs)
    assert meteor.meteor_15(hyps, refs) == jax_meteor.meteor_15(hyps, refs)
    # the injectable synonym and paraphrase stages (tests/test_meteor.py's)
    syn = {"car": {1}, "automobile": {1}, "quick": {2}, "fast": {2}}
    tab = {(("right", "away"), ("immediately",))}
    cand = [["the", "automobile", "is", "quick", "do", "it", "right",
             "away"]]
    refs = [[["the", "car", "is", "fast", "do", "it", "immediately"]]]
    for kw in (dict(synonyms=lambda w: syn.get(w, set())),
               dict(paraphrases=tab),
               dict(paraphrases=lambda a, b: (a, b) in tab)):
        assert meteor.meteor_15(cand, refs, **kw) == \
            jax_meteor.meteor_15(cand, refs, **kw)
        assert meteor.align_modules_full(cand[0], refs[0][0], **kw) == \
            jax_meteor.align_modules_full(cand[0], refs[0][0], **kw)


@pytest.mark.parametrize("version", ["1.5", "2005"])
def test_step_captions_equal(version, synthetic, tmp_path):
    """evaluate_step_captions on the JAX test's captions and the synthetic
    split's, with the three model plugins stubbed by the same functions;
    make_clipscore_fn on the same frames with stub encoders."""
    frames = tmp_path / "frames"
    rng = np.random.default_rng(2)
    for vid in CAPTION_GT:
        d = frames / vid
        d.mkdir(parents=True)
        for i in range(1, 9):
            (d / f"frame_{i:04d}.jpg").write_bytes(b"")
    feats = {}

    def preprocess(path):
        return feats.setdefault(path, rng.normal(size=4).astype(np.float32))

    def enc_img(x):
        return np.asarray(x) * 2

    def enc_txt(texts):
        return np.stack([np.full(4, len(t), np.float32) - 3 for t in texts])

    clip_p = captions.make_clipscore_fn(str(frames), enc_img, enc_txt,
                                        preprocess)
    clip_j = jax_captions.make_clipscore_fn(str(frames), enc_img, enc_txt,
                                            preprocess)
    for gt, pred in ((CAPTION_GT, CAPTION_PRED),
                     (synthetic["gt"], synthetic["caps"])):
        kw = dict(entailment_fn=lambda g, c: len(g + c) % 3,
                  bertscore_fn=lambda c, r: float(len("".join(c + r))))
        got = captions.evaluate_step_captions(
            gt, pred, clipscore_fn=clip_p,
            coco_evaluator=coco.CocoEvaluator(meteor_version=version), **kw)
        want = jax_captions.evaluate_step_captions(
            gt, pred, clipscore_fn=clip_j,
            coco_evaluator=jax_coco.CocoEvaluator(meteor_version=version),
            **kw)
        assert got == want


def test_make_gt_equal(synthetic, tmp_path):
    assert make_gt.build_formatted_gt(synthetic["anns"]) == synthetic["gt"]
    split = synthetic["data"] / "all_data_val.json"
    make_gt.main(["--split_json", str(split), "--out", str(tmp_path / "p")])
    jax_make_gt.main(["--split_json", str(split), "--out",
                      str(tmp_path / "j")])
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


# --- NLI and BERTScore on seeded weights ----------------------------------


def _nli_sd(seed=0):
    sd = random_nli_state_dict(MiniLmConfig(**NLI_SPEC), seed=seed)
    # the layers' weights 10x the init's 0.02 (scores and updates of order
    # one), the head's 100x and without its biases: labels that differ
    # per pair
    for k in sd:
        if k.startswith("bert.encoder") and k.endswith("dense.weight") or \
                k.endswith(("query.weight", "key.weight", "value.weight")):
            sd[k] = sd[k] * np.float32(10.0)
        elif k.startswith(("classifier", "bert.pooler")):
            sd[k] = (sd[k] * np.float32(100.0) if k.endswith("weight")
                     else np.zeros_like(sd[k]))
    return sd


def _write_nli_dir(d, sd, id2label=MNLI_LABELS, fmt="safetensors"):
    from safetensors.numpy import save_file

    d.mkdir(parents=True, exist_ok=True)
    if fmt == "safetensors":
        save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
                  str(d / "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   d / "pytorch_model.bin")
    cfg = {"model_type": "bert", "type_vocab_size": 2,
           "layer_norm_eps": 1e-12, **NLI_SPEC}
    if id2label is not None:
        cfg["id2label"] = {str(k): v for k, v in id2label.items()}
    (d / "config.json").write_text(json.dumps(cfg))
    words = WORDS + [f"w{i}" for i in range(NLI_SPEC["vocab_size"]
                                            - len(WORDS))]
    (d / "vocab.txt").write_text("\n".join(words) + "\n")
    return d


PAIRS = [("the cat sat on a mat", "a dog ran"), ("a dog ran", "the cat sat"),
         ("the cat", "the cat"), ("a on the", "mat mat mat"),
         ("sat sat", "ran ran a"), ("add salt", "mix water pan"),
         ("w1 w2 w3 w4 w5 w6 w7 w8 w9 w10 w11 w12 w13 w14", "w15 w16")]


def test_nli_logits_and_labels_match_jax(tmp_path):
    sd = _nli_sd()
    cfg = MiniLmConfig(**NLI_SPEC)
    jcfg = JaxMiniLmConfig(**NLI_SPEC)
    model = nli.load_nli(sd, cfg, 3, "cpu")
    jmodel = jax_nli.NliCrossEncoder(jcfg)
    jparams = {"params": jax_nli.convert_nli(sd, jcfg)}
    from hirest_tpu_torch.tokenizers import WordPieceTokenizer

    d = _write_nli_dir(tmp_path / "nli", sd)
    tok = WordPieceTokenizer(str(d / "vocab.txt"))
    rows = [nli.encode_pair(tok, p, h, 16) for p, h in PAIRS]
    for (a, b, c), (p, h) in zip(rows, PAIRS):
        from hirest_tpu.tokenizers import WordPieceTokenizer as JaxWordPiece

        ja, jb, jc = jax_nli.encode_pair(JaxWordPiece(str(d / "vocab.txt")),
                                         p, h, 16)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(c, jc)
    ids, types, mask = (np.stack(col) for col in zip(*rows))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(types)).numpy()
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(ids),
                                   jnp.asarray(mask), jnp.asarray(types)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert len(set(want.argmax(1).tolist())) > 1  # the labels vary
    # the JAX tree back to an HF state dict gives the same logits
    back = nli.load_nli(nli_from_jax(jparams), cfg, 3, "cpu")
    with torch.inference_mode():
        again = back(torch.from_numpy(ids), torch.from_numpy(mask),
                     torch.from_numpy(types)).numpy()
    assert np.abs(again - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_entailment_fn_matches_jax(fmt, tmp_path, monkeypatch):
    """make_nli_entailment_fn from an HF model dir: the same labels as the
    JAX function; `.batch` equal to per-pair calls; the .safetensors and
    .bin layouts equal."""
    sd = _nli_sd(seed=1)
    d = _write_nli_dir(tmp_path / fmt, sd, fmt=fmt)
    fn = nli.make_nli_entailment_fn(str(d), max_length=16, device="cpu")
    want = jax_nli.make_nli_entailment_fn(str(d), max_length=16).batch(PAIRS)
    assert fn.batch(PAIRS) == want
    assert [fn(p, h) for p, h in PAIRS] == want
    other = _write_nli_dir(tmp_path / "other", sd,
                           fmt="bin" if fmt == "safetensors" else
                           "safetensors")
    assert nli.make_nli_entailment_fn(str(other), max_length=16,
                                      device="cpu").batch(PAIRS) == want
    monkeypatch.setattr(nli, "CHUNK", 3)  # pairs over several forwards
    assert fn.batch(PAIRS) == want


def test_entailment_fn_loud_errors(tmp_path):
    sd = _nli_sd()
    d = _write_nli_dir(tmp_path / "nolabels", sd, id2label=None)
    with pytest.raises(ValueError, match="id2label"):
        nli.make_nli_entailment_fn(str(d), device="cpu")
    d2 = _write_nli_dir(tmp_path / "auto", sd, id2label={
        0: "LABEL_0", 1: "LABEL_1", 2: "LABEL_2"})
    with pytest.raises(ValueError, match="id2label"):
        nli.make_nli_entailment_fn(str(d2), device="cpu")
    fn = nli.make_nli_entailment_fn(str(d), max_length=16, device="cpu",
                                    id2label=MNLI_LABELS)
    ref = nli.make_nli_entailment_fn(
        str(_write_nli_dir(tmp_path / "labeled", sd)), max_length=16,
        device="cpu")
    assert fn.batch(PAIRS) == ref.batch(PAIRS)
    (d / "model.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        nli.make_nli_entailment_fn(str(d), device="cpu", id2label=MNLI_LABELS)
    assert nli.nli_label_remap(MNLI_LABELS) == \
        jax_nli.nli_label_remap(MNLI_LABELS) == {0: 1, 1: 2, 2: 0}
    with pytest.raises(ValueError, match="unmapped"):
        nli.nli_label_remap({0: "yes", 1: "no"})


def test_bertscore_pairs_equal():
    rng = np.random.default_rng(3)
    c, r = rng.normal(size=(5, 9, 16)), rng.normal(size=(5, 7, 16))
    cm, rm = rng.random((5, 9)) > 0.3, rng.random((5, 7)) > 0.3
    cm[0], rm[1] = False, False  # a pair with no content tokens
    for got, want in zip(bertscore_pairs(c, cm, r, rm),
                         jax_bertscore_pairs(c, cm, r, rm)):
        np.testing.assert_array_equal(got, want)


def test_make_bertscore_fn_matches_jax(tmp_path):
    """F1 through the port's encoder (pool=False, content tokens only)
    within 1e-6 of the JAX function's, on a checkpoint file both load."""
    spec = dict(vocab_size=60, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64)
    sd = random_minilm_state_dict(MiniLmConfig(**spec), seed=4)
    ckpt = tmp_path / "bert.bin"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(WORDS + [f"w{i}" for i in range(40)]) + "\n")
    cands = ["add salt", "mix the water", "the cat sat on a mat", "", "pan"]
    refs = ["add the salt", "mix water", "a dog ran", "the cat", "w1 w2 pan"]
    got = make_bertscore_fn(str(ckpt), str(vocab), config=MiniLmConfig(
        **spec), batch_size=2, device="cpu")
    want = jax_bertscore_fn(str(ckpt), str(vocab), config=JaxMiniLmConfig(
        **spec), batch_size=2)
    assert abs(got(cands, refs) - want(cands, refs)) <= 1e-6
    emb, content = got.encode(["add salt", "the"])
    assert emb.shape == (2, 64, 32)
    assert content.sum(1).tolist() == [2, 1]  # no CLS, SEP or padding


# --- the .safetensors reader, the download frontend -----------------------


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as torch_load_file
    from safetensors.torch import save_file as torch_save_file

    rng = np.random.default_rng(5)
    arrays = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(7,)).astype(np.float16),
              "i64": rng.integers(-2 ** 40, 2 ** 40, (2, 2, 3)),
              "scalar": np.array(2.5, np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"))
    got = load_safetensors(str(tmp_path / "a.safetensors"))
    want = load_file(str(tmp_path / "a.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    bf = {"bf16": torch.from_numpy(rng.normal(size=(4, 6)).astype(
        np.float32)).bfloat16()}
    torch_save_file(bf, str(tmp_path / "b.safetensors"))
    got = load_safetensors(str(tmp_path / "b.safetensors"))["bf16"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch_load_file(str(tmp_path /
                                                "b.safetensors"))["bf16"])
    # the writer: the package reads what it writes, byte for byte the
    # values and dtypes
    save_safetensors(tmp_path / "c.safetensors", arrays)
    back = load_file(str(tmp_path / "c.safetensors"))
    assert set(back) == set(arrays)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(back[k], a)
    # load_torch_ckpt reads both layouts into f32
    sd = load_torch_ckpt(str(tmp_path / "a.safetensors"))
    assert all(v.dtype == torch.float32 for v in sd.values())
    np.testing.assert_array_equal(sd["i64"].numpy(),
                                  arrays["i64"].astype(np.float32))


def test_download_split_walk_and_gate(synthetic, tmp_path, monkeypatch):
    data = str(synthetic["data"])
    assert download._ids_from_splits(data) == \
        jax_download._ids_from_splits(data)
    assert len(download._ids_from_splits(data)) == 54
    monkeypatch.setitem(sys.modules, "pytube", None)
    with pytest.raises(ImportError, match="pytube"):
        download.download_videos(["a"], str(tmp_path / "videos"))
    assert not (tmp_path / "videos").exists()
