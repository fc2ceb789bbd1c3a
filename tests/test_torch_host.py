"""The port's own copies of the JAX package's host modules give the JAX
package's output, byte for byte: the timeline, the native feature packing
(compiled and NumPy fallback), SRT parsing, annotations, batching, the
feature store, both tokenizers and the run configuration."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import hirest_tpu.config as jax_config
import hirest_tpu.data.annotations as jax_ann
import hirest_tpu.data.batching as jax_batching
import hirest_tpu.native as jax_native
import hirest_tpu.timeline as jax_timeline
import hirest_tpu.tokenizers.bpe as jax_bpe
import hirest_tpu_torch.config as port_config
import hirest_tpu_torch.data.annotations as port_ann
import hirest_tpu_torch.data.batching as port_batching
import hirest_tpu_torch.native as port_native
import hirest_tpu_torch.timeline as port_timeline
import hirest_tpu_torch.tokenizers.bpe as port_bpe
from hirest_tpu.data.features import FeatureStore as JaxFeatureStore
from hirest_tpu.data.srt import parse_srt as jax_parse_srt
from hirest_tpu.tokenizers import WordPieceTokenizer as JaxWordPiece
from hirest_tpu.tokenizers.wordpiece import \
    detokenize_caption as jax_detokenize
from hirest_tpu_torch.data.features import FeatureStore
from hirest_tpu_torch.data.srt import parse_srt
from hirest_tpu_torch.tokenizers import WordPieceTokenizer
from hirest_tpu_torch.tokenizers.wordpiece import detokenize_caption


def _same(a, b):
    """Equal structure and equal bytes (arrays: dtype, shape, values)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b and type(a) is type(b)


# -- timeline ---------------------------------------------------------------


@pytest.mark.parametrize("n_frames", [-1, 7, 64])
def test_timeline_matches_jax(n_frames):
    rng = np.random.default_rng(0)
    for duration in (1.0, 17.0, 88.4, 199.6):
        _same(port_timeline.timeline_bins(duration, n_frames),
              jax_timeline.timeline_bins(duration, n_frames))
        n = n_frames if n_frames > 0 else int(duration)
        for ts in rng.uniform(0, duration, size=8):
            _same(port_timeline.timestamp_to_frame_index(ts, duration,
                                                         n_frames),
                  jax_timeline.timestamp_to_frame_index(ts, duration,
                                                        n_frames))
        for i in range(n):
            _same(port_timeline.frame_index_to_timestamp(i, duration,
                                                         n_frames),
                  jax_timeline.frame_index_to_timestamp(i, duration,
                                                        n_frames))
    feats = rng.normal(size=(23, 5)).astype(np.float32)
    for target in (1, 5, 23, 40):
        _same(port_timeline.resample_frames(feats, target),
              jax_timeline.resample_frames(feats, target))
        mask = (rng.random(23) > 0.5).astype(np.int32)
        _same(port_timeline.trim_to_moment(feats, mask, target),
              jax_timeline.trim_to_moment(feats, mask, target))
    bounds = [(0, 3), (2, 9), (8, 30), (12, 12)]
    _same(port_timeline.warp_segments(feats[:4], bounds, 20),
          jax_timeline.warp_segments(feats[:4], bounds, 20))


# -- native feature packing --------------------------------------------------


@pytest.fixture(params=["compiled", "numpy"])
def native_pair(request, monkeypatch):
    """Both packages' native modules, compiled or forced onto the NumPy
    fallback."""
    if request.param == "numpy":
        for mod in (port_native, jax_native):
            monkeypatch.setattr(mod, "_load", lambda: None)
    else:
        assert port_native.available()
    return port_native, jax_native


def test_native_matches_jax(native_pair):
    port, ref = native_pair
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(n, 6)).astype(np.float32) for n in (3, 40, 17)]
    for bucket, n_model in ((64, -1), (16, -1), (64, 20), (8, 30)):
        _same(port.pack_batch(feats, bucket, n_model),
              ref.pack_batch(feats, bucket, n_model))
    mask = np.zeros(40, np.int32)
    mask[5:17] = 1
    for target in (4, 12, 20):
        _same(port.trim_to_moment(feats[1], mask, target),
              ref.trim_to_moment(feats[1], mask, target))
    _same(port.trim_to_moment(feats[1], np.zeros(40, np.int32), 5),
          ref.trim_to_moment(feats[1], np.zeros(40, np.int32), 5))
    bounds = [(0, 2), (1, 30), (29, 60)]
    _same(port.warp_segments(feats[2][:3], bounds, 45),
          ref.warp_segments(feats[2][:3], bounds, 45))


# -- SRT, annotations, batching, features ------------------------------------

SRT = """1
00:00:00,000 --> 00:00:02,500
hello there

2
00:00:02,500 --> 00:00:07,040
mix the oats
and water

00:00:09.1 --> 00:00:12,000
no index line
"""


def test_srt_matches_jax():
    _same([dataclasses.astuple(s) for s in parse_srt(SRT)],
          [dataclasses.astuple(s) for s in jax_parse_srt(SRT)])


def _annotations():
    steps = [{"index": i, "heading": f" step {i} ",
              "absolute_bounds": [5 + 9 * i, 14 + 9 * i]} for i in range(4)]
    return {
        "make pancakes": {
            "vid0.mp4": {"relevant": True, "clip": True, "v_duration": 60.4,
                         "bounds": [5, 41], "steps": steps},
            "vid1.mp4": {"relevant": True, "clip": True, "v_duration": 50.0,
                         "bounds": [2, 30], "steps": steps[:2]},
            "vid9.mp4": {"relevant": False, "clip": True, "v_duration": 9.0,
                         "bounds": [0, 5], "steps": []}},
        "fold a shirt": {
            "vid2.mp4": {"relevant": True, "clip": True, "v_duration": 70.2,
                         "bounds": [10, 66], "steps": []}},
    }


ANN_CASES = [(task, n, train, e2e)
             for task in ("moment_retrieval", "moment_segmentation",
                          "step_captioning")
             for n, train, e2e in ((-1, False, False), (32, True, False),
                                   (-1, False, True))]


@pytest.mark.parametrize("task,n_model,is_train,e2e", ANN_CASES)
def test_build_examples_matches_jax(task, n_model, is_train, e2e):
    _same(port_ann.build_examples(_annotations(), task, n_model, is_train,
                                  e2e),
          jax_ann.build_examples(_annotations(), task, n_model, is_train,
                                 e2e))


TINY_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
              "add", "salt", "and", "water", "mix", "##ing", "##ed", "pan",
              "##cake", "oat", "##meal", ",", "."]


@pytest.fixture()
def wordpieces(tmp_path):
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("\n".join(TINY_VOCAB) + "\n")
    return WordPieceTokenizer(str(vocab_file)), JaxWordPiece(str(vocab_file))


def test_wordpiece_matches_jax(wordpieces):
    port, ref = wordpieces
    texts = ["oatmeal pancake", "Add salt, and water.", "zzzqqq mixing",
             "Mixed  PAN-cake!", "ÀDD sàlt 水 and"]
    for text in texts:
        _same(port.tokenize(text), ref.tokenize(text))
        ids = port.convert_tokens_to_ids(port.tokenize(text))
        _same(ids, ref.convert_tokens_to_ids(ref.tokenize(text)))
        toks = port.convert_ids_to_tokens(ids)
        _same(toks, ref.convert_ids_to_tokens(ids))
        _same(detokenize_caption(toks), jax_detokenize(toks))
        for max_words in (4, 8):
            _same(port_ann.caption_targets(port, text, max_words),
                  jax_ann.caption_targets(ref, text, max_words))


@pytest.fixture()
def feature_dirs(tmp_path):
    """Visual features as .npy, .npz and .pt, and ASR features with their
    SRT files."""
    rng = np.random.default_rng(2)
    vis, asr, srt = (tmp_path / d for d in ("vis", "asr_feats", "asr"))
    for d in (vis, asr, srt):
        d.mkdir()
    np.save(vis / "vid0.mp4.npy", rng.normal(size=(60, 8)).astype(np.float32))
    np.savez(vis / "vid1.mp4.npz", rng.normal(size=(50, 8)).astype(np.float32))
    torch.save(torch.from_numpy(rng.normal(size=(70, 8)).astype(np.float32)),
               vis / "vid2.mp4.pt")
    for vid in ("vid0", "vid1", "vid2"):
        np.save(asr / f"{vid}.npy", rng.normal(size=(3, 4)).astype(np.float32))
        (srt / f"{vid}.srt").write_text(SRT)
    return str(vis), str(srt), str(asr)


def test_feature_store_matches_jax(feature_dirs):
    port, ref = FeatureStore(*feature_dirs), JaxFeatureStore(*feature_dirs)
    for fname in ("vid0.mp4", "vid1.mp4", "vid2.mp4"):
        for n_model in (-1, 16, 100):
            _same(port.visual(fname, n_model), ref.visual(fname, n_model))
            _same(port.asr(fname, 55, n_model), ref.asr(fname, 55, n_model))
    with pytest.raises(FileNotFoundError):
        port.visual("nope.mp4")


@pytest.mark.parametrize("task", ["moment_retrieval", "moment_segmentation",
                                  "step_captioning"])
def test_collate_and_batcher_match_jax(feature_dirs, wordpieces, task):
    port_store = FeatureStore(*feature_dirs)
    ref_store = JaxFeatureStore(*feature_dirs)
    anns = _annotations()
    anns["make pancakes"]["vid1.mp4"]["v_duration"] = 80.0  # past its features
    for n_model, is_train in ((-1, False), (32, True)):
        port_ex = port_ann.build_examples(anns, task, n_model, is_train)
        ref_ex = jax_ann.build_examples(anns, task, n_model, is_train)
        if task == "step_captioning":
            for ex, mod, tok in ((port_ex, port_ann, wordpieces[0]),
                                 (ref_ex, jax_ann, wordpieces[1])):
                for e in ex:
                    e.update(mod.caption_targets(tok, e["target_text_raw"],
                                                 8))
        _same(port_batching.collate(port_ex, port_store, (64, 128)),
              jax_batching.collate(ref_ex, ref_store, (64, 128)))
        _same(port_batching.collate(port_ex[:1], port_store, (64, 128),
                                    pad_batch_to=3),
              jax_batching.collate(ref_ex[:1], ref_store, (64, 128),
                                   pad_batch_to=3))
        for kw in (dict(shuffle=True, seed=3), dict(num_hosts=2, host_id=1,
                                                    pad_hosts=True),
                   dict(pad_batch=True, drop_last=False)):
            port_b = port_batching.TaskBatcher(port_ex, 2, port_store,
                                               (64, 128), **kw)
            ref_b = jax_batching.TaskBatcher(ref_ex, 2, ref_store, (64, 128),
                                             **kw)
            port_b.set_epoch(1)
            ref_b.set_epoch(1)
            assert len(port_b) == len(ref_b)
            _same(list(port_b), list(ref_b))


def test_pick_bucket_matches_jax():
    for n in (1, 64, 65, 2048):
        assert (port_batching.pick_bucket(n, port_batching.DEFAULT_BUCKETS)
                == jax_batching.pick_bucket(n, jax_batching.DEFAULT_BUCKETS))
    with pytest.raises(ValueError):
        port_batching.pick_bucket(4096, port_batching.DEFAULT_BUCKETS)


# -- CLIP BPE ------------------------------------------------------------------

PROMPTS = ["Make Oatmeal Pancake Mix", "a photo of a cat", "hello world",
           "how_to fold a T-shirt (quickly)!", "it's 3 o'clock; we'll go",
           "Crème brûlée au café", "数字 123 and émojis 🙂", "",
           "  lots   of\tspace  ", "&amp; html &lt;b&gt;"]


def test_clip_tokenize_matches_jax():
    _same(port_bpe.clip_tokenize(PROMPTS), jax_bpe.clip_tokenize(PROMPTS))
    long_text = "word " * 200
    _same(port_bpe.clip_tokenize(long_text, truncate=True),
          jax_bpe.clip_tokenize(long_text, truncate=True))
    with pytest.raises(RuntimeError):
        port_bpe.clip_tokenize(long_text)


@pytest.mark.parametrize("with_regex", [True, False])
def test_bpe_word_split_branches_match_jax(monkeypatch, with_regex):
    """Both word-split branches: the `regex` module's \\p{L}/\\p{N} pattern
    where it is installed, the stdlib `re` one where it is not."""
    if with_regex:
        pytest.importorskip("regex")
    else:
        monkeypatch.setitem(sys.modules, "regex", None)
    port, ref = port_bpe.ClipBPETokenizer(), jax_bpe.ClipBPETokenizer()
    assert port.pat.pattern == ref.pat.pattern
    for text in PROMPTS:
        _same(port.encode(text), ref.encode(text))
        _same(port.decode(port.encode(text)), ref.decode(ref.encode(text)))


# -- configuration -------------------------------------------------------------


def test_config_matches_jax():
    """The same fields and defaults, `device` alone reading "cuda"; the
    same flags; the same derived joint config."""
    port_fields = {f.name: f.default for f in
                   dataclasses.fields(port_config.HirestConfig)}
    ref_fields = {f.name: f.default for f in
                  dataclasses.fields(jax_config.HirestConfig)}
    assert port_fields.pop("device") == "cuda"
    ref_fields.pop("device")
    assert port_fields == ref_fields
    argv = ["--data_dir", "d", "--video_feature_dir", "v", "--fp16",
            "--asr_feature_dir", "/x/asr_minilm", "--frame_buckets", "32,64",
            "--task_step_captioning", "--num_beams", "4",
            "--visual_num_hidden_layers", "3"]
    port = port_config.HirestConfig.from_args(argv)
    ref = jax_config.HirestConfig.from_args(argv)
    assert port.device == "cuda" and ref.device == "tpu"
    port.device = ref.device
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.tasks == ref.tasks and port.asr_dim == ref.asr_dim == 384
    assert (dataclasses.asdict(port.joint_model_config())
            == dataclasses.asdict(ref.joint_model_config()))
    assert port.to_json() == ref.to_json()
    port_flags = {a.dest: a.default for a in
                  port_config.get_parser()._actions}
    ref_flags = {a.dest: a.default for a in jax_config.get_parser()._actions}
    assert port_flags.pop("device") == "cuda"
    ref_flags.pop("device")
    assert port_flags == ref_flags
