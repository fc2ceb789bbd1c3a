"""The port's Trainer (inference half) and ServingEngine against the JAX
package's, on the CPU, sharing the JAX trainer's weights (carried across
with `moment_model_from_jax`) and one numpy text function; then the port's
HTTP server on port 0, mirroring tests/test_serve.py.

Tolerances: retrieval scores within 1e-5; every decision (moment bounds,
step boundaries, beam ids and so captions) equal."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from hirest_tpu.data.annotations import build_examples as jax_build_examples
from hirest_tpu.data.batching import collate as jax_collate
from hirest_tpu.serve import ServingEngine as JaxServingEngine
from hirest_tpu.tokenizers import WordPieceTokenizer as JaxWordPiece
from hirest_tpu.train.trainer import Trainer as JaxTrainer
from hirest_tpu_torch.data.annotations import build_examples
from hirest_tpu_torch.data.batching import collate
from hirest_tpu_torch.models.convert import moment_model_from_jax
from hirest_tpu_torch.models.joint import MomentModel
from hirest_tpu_torch.serve import ServingEngine, make_server
from hirest_tpu_torch.tokenizers import WordPieceTokenizer
from hirest_tpu_torch.train.trainer import Trainer

from torch_port_util import SERVE_JOINT, hirest_configs, joint_configs

VIDEOS = [f"vid{i}.mp4" for i in range(4)]
PROMPTS = ["make pancakes", "fold a shirt", "how to tie a tie"]


def _text_fn(ids):
    """A deterministic text feature of the token ids, shared by both
    packages (the EVA text tower has its own parity tests)."""
    w = np.random.default_rng(7).normal(size=(77, 1024)).astype(np.float32)
    return (np.asarray(ids, np.float32) / 49407.0) @ w


def _feature_dir(tmp):
    feats = tmp / "feats"
    feats.mkdir()
    rng = np.random.default_rng(0)
    for i, name in enumerate(VIDEOS):
        np.save(feats / f"{name}.npy",
                rng.normal(size=(40 + i * 10, 1024)).astype(np.float32))
    return feats


def _pair(feats, tmp, tokenizers=(None, None), **overrides):
    """(JAX engine, port engine) on one config and the JAX weights."""
    kw = dict(video_feature_dir=str(feats), task_moment_retrieval=True,
              task_moment_segmentation=True, task_step_captioning=True,
              eval_batch_size=1, num_beams=2, max_words=8,
              moment_segmentation_max_iterations=4, frame_buckets=(64, 128),
              pretrained_dir=str(tmp / "none"))
    kw.update(overrides)
    jax_cfg, cfg = hirest_configs(**kw)
    jax_model_cfg, model_cfg = joint_configs(SERVE_JOINT)
    jax_trainer = JaxTrainer(jax_cfg, text_encoder_fn=_text_fn,
                             wordpiece_tokenizer=tokenizers[1],
                             verbose=False, model_config=jax_model_cfg)
    model = MomentModel(model_cfg)
    model.load_state_dict(moment_model_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_trainer.params)))
    trainer = Trainer(cfg, text_encoder_fn=_text_fn,
                      wordpiece_tokenizer=tokenizers[0], model=model,
                      verbose=False, model_config=model_cfg)
    return (JaxServingEngine(jax_cfg, trainer=jax_trainer),
            ServingEngine(cfg, trainer=trainer))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    return _pair(_feature_dir(tmp), tmp)


def test_retrieve_matches_jax(engines):
    jax_engine, engine = engines
    for prompt in PROMPTS:
        got, want = engine.retrieve(prompt, 4), jax_engine.retrieve(prompt, 4)
        assert got["videos"] == want["videos"]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("video", VIDEOS)
def test_analyze_matches_jax(engines, video):
    """The tiny 40-token vocabulary of tests/test_serve.py, below the
    default BOS/EOS ids: the port clamps as JAX does, no index error."""
    jax_engine, engine = engines
    want = jax_engine.analyze("make pancakes", video)
    got = engine.analyze("make pancakes", video)
    assert got == want
    assert got["steps"], got


def test_analyze_fused_segmentation_matches_jax(engines):
    jax_engine, engine = engines
    for e in engines:
        e.config.fused_segmentation = True
    try:
        for video in VIDEOS[:2]:
            assert (engine.analyze("fold a shirt", video, 45.0)
                    == jax_engine.analyze("fold a shirt", video, 45.0))
    finally:
        for e in engines:
            e.config.fused_segmentation = False


def _batch(task, build, collater, store, buckets):
    anns = {"make pancakes": {
        v: {"relevant": True, "clip": True, "v_duration": 40.0 + 10 * i,
            "bounds": [3, 30 + 5 * i],
            "steps": [{"index": j, "heading": "", "absolute_bounds":
                       [3 + 8 * j, 10 + 8 * j]} for j in range(3)]}
        for i, v in enumerate(VIDEOS[:3])}}
    ex = build(anns, task, -1, end_to_end=True)
    return collater(ex, store, buckets, pad_batch_to=len(ex) + 1)


@pytest.mark.parametrize("fused", [False, True])
def test_trainer_predictions_match_jax(engines, fused):
    """The three `_predict_*` on one collated batch each (padded with a
    batch_mask row, so `_prepare` repeat-pads the prompts)."""
    jax_trainer, trainer = engines[0].trainer, engines[1].trainer
    for t in (jax_trainer, trainer):
        t.config.fused_segmentation = fused
    try:
        for task in ("moment_retrieval", "moment_segmentation",
                     "step_captioning"):
            want_batch = _batch(task, jax_build_examples, jax_collate,
                                jax_trainer.store, jax_trainer.buckets)
            batch = _batch(task, build_examples, collate, trainer.store,
                           trainer.buckets)
            want_arrs = jax_trainer._prepare(want_batch, task)
            arrs = trainer._prepare(batch, task)
            for k, v in want_arrs.items():
                np.testing.assert_allclose(arrs[k].numpy(), np.asarray(v),
                                           rtol=1e-6, atol=1e-6, err_msg=k)
            if task == "moment_segmentation":
                got = trainer._predict_moment_segmentation(arrs, batch)
                want = jax_trainer._predict_moment_segmentation(want_arrs,
                                                                want_batch)
            else:
                name = f"_predict_{task}"
                got = getattr(trainer, name)(arrs)
                want = getattr(jax_trainer, name)(want_arrs)
            assert got == want, task
    finally:
        for t in (jax_trainer, trainer):
            t.config.fused_segmentation = False


def test_reference_checkpoint_predictions_match_jax(engines, tmp_path):
    """`load_torch_checkpoint` of one reference-format `.pth` in both
    trainers: the same analysis."""
    jax_engine, engine = engines
    sd = moment_model_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x) * 1.5, jax_engine.trainer.params))
    path = tmp_path / "BEST.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    jax_params, port_state = jax_engine.trainer.params, \
        engine.trainer.model.state_dict()
    try:
        jax_engine.trainer.load_torch_checkpoint(str(path))
        engine.trainer.load_torch_checkpoint(str(path))
        assert (engine.analyze("make pancakes", VIDEOS[1])
                == jax_engine.analyze("make pancakes", VIDEOS[1]))
    finally:
        jax_engine.trainer.params = jax_params
        engine.trainer.model.load_state_dict(port_state)


TINY_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "add", "salt",
               "and", "water", "mix", "##ing", "##ed", "pan", "##cake", "oat",
               "##meal", ",", "."] + [f"w{i}" for i in range(22)])


def test_analyze_with_wordpiece_matches_jax(tmp_path):
    """With a WordPiece vocabulary, BOS/EOS are its [CLS]/[SEP] and the
    captions are detokenized text: the same text in both packages."""
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(TINY_VOCAB) + "\n")
    jax_engine, engine = _pair(
        _feature_dir(tmp_path), tmp_path,
        tokenizers=(WordPieceTokenizer(str(vocab)), JaxWordPiece(str(vocab))))
    want = jax_engine.analyze("make pancakes", VIDEOS[2])
    assert engine.analyze("make pancakes", VIDEOS[2]) == want
    assert any(s["caption"] for s in want["steps"]), want


# -- the HTTP server ------------------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def served(engines):
    server = make_server(engines[1], port=0)  # an OS-assigned free port
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", engines
    server.shutdown()
    server.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def test_http_health(served):
    url, _ = served
    with urllib.request.urlopen(f"{url}/health", timeout=30) as r:
        data = json.loads(r.read())
    assert data == {"status": "ok", "devices": ["cpu (cpu)"],
                    "indexed_videos": 4}


def test_http_retrieve_and_analyze_match_jax(served):
    url, (jax_engine, _) = served
    status, data = _post(f"{url}/v1/retrieve", {"prompt": "make pancakes",
                                                "top_k": 3})
    assert status == 200
    want = jax_engine.retrieve("make pancakes", 3)
    assert data["videos"] == want["videos"]
    np.testing.assert_allclose(data["scores"], want["scores"], atol=1e-5)
    status, data = _post(f"{url}/v1/analyze", {"prompt": "make pancakes",
                                               "video": "vid0.mp4"})
    assert status == 200
    assert data == jax_engine.analyze("make pancakes", "vid0.mp4")


@pytest.mark.parametrize("path,payload,code", [
    ("/v1/retrieve", {}, 400),
    ("/v1/retrieve", {"prompt": "x", "top_k": 0}, 400),
    ("/v1/retrieve", {"prompt": "x", "top_k": "many"}, 400),
    ("/v1/analyze", {"prompt": "x"}, 400),
    ("/v1/analyze", {"prompt": "x", "video": "nope.mp4"}, 404),
    ("/v1/nope", {}, 404),
])
def test_http_error_paths(served, path, payload, code):
    url, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}{path}", payload)
    assert e.value.code == code


def test_http_bad_body_and_unknown_get(served):
    url, _ = served
    req = urllib.request.Request(f"{url}/v1/retrieve", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nope", timeout=30)
    assert e.value.code == 404


def test_warmup_runs_both_endpoints(engines):
    assert engines[1].warmup() == {"retrieve": True, "analyze": True}


# -- video retrieval ------------------------------------------------------------


def test_retrieval_functions_match_jax(tmp_path):
    """encode_texts, both video encoders (features, with and without the
    linspace resample; JPEG frames under both directory namings) and
    score_and_dump give the JAX package's arrays and JSON."""
    from PIL import Image

    import hirest_tpu.infer.retrieval as ref
    import hirest_tpu_torch.infer.retrieval as port
    from hirest_tpu_torch.models.eva_clip import preprocess_image

    feats = _feature_dir(tmp_path)
    ids = list(VIDEOS)
    np.testing.assert_array_equal(port.encode_texts(_text_fn, PROMPTS, 2),
                                  ref.encode_texts(_text_fn, PROMPTS, 2))
    np.testing.assert_array_equal(
        port.encode_texts(lambda i: torch.from_numpy(_text_fn(i)), PROMPTS),
        ref.encode_texts(_text_fn, PROMPTS))
    for n in (-1, 16, 100):
        np.testing.assert_array_equal(
            port.encode_videos_from_features(str(feats), ids, n),
            ref.encode_videos_from_features(str(feats), ids, n))
    with pytest.raises(FileNotFoundError):
        port.encode_videos_from_features(str(feats), ["nope.mp4"], -1)

    frames = tmp_path / "frames"
    rng = np.random.default_rng(3)
    for vid, dirname in (("a", "a"), ("b.mp4", "b.mp4"), ("c.mp4", "c")):
        (frames / dirname).mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (40, 56, 3), np.uint8)).save(
                frames / dirname / f"frame_{i:06d}.jpg")
    w = rng.normal(size=(3, 8)).astype(np.float32)

    def encode_image(x):
        return np.asarray(x, np.float32).mean(axis=(1, 2)) @ w

    want = ref.encode_videos_from_frames(
        str(frames), ["a", "b.mp4", "c.mp4"], encode_image, preprocess_image,
        4, batch_size=3, save_feature_dir=str(tmp_path / "want"))
    got = port.encode_videos_from_frames(
        str(frames), ["a", "b.mp4", "c.mp4"],
        lambda x: torch.from_numpy(encode_image(x)), preprocess_image, 4,
        batch_size=3, save_feature_dir=str(tmp_path / "got"))
    np.testing.assert_array_equal(got, want)
    for vid in ("a", "b.mp4", "c.mp4"):
        np.testing.assert_array_equal(np.load(tmp_path / "got" / f"{vid}.npy"),
                                      np.load(tmp_path / "want" / f"{vid}.npy"))

    text = ref.encode_texts(_text_fn, PROMPTS)
    video = ref.encode_videos_from_features(str(feats), ids, -1)
    got = port.score_and_dump(PROMPTS, ids, text, video, "run",
                              str(tmp_path / "got"))
    want = ref.score_and_dump(PROMPTS, ids, text, video, "run",
                              str(tmp_path / "want"))
    assert got == want
    assert ((tmp_path / "got" / "run.json").read_text()
            == (tmp_path / "want" / "run.json").read_text())
