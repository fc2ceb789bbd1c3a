"""The port's custom-video pipeline against the JAX package on the CPU:
probe_duration and the one-video annotation on an mp4 written with OpenCV,
frame extraction (the same JPEG files), and run_custom_video end to end
with the tiny joint model on shared weights and fake towers (the same
result and files)."""

import json
import os

import numpy as np
import pytest
import torch

from hirest_tpu.extraction import frames as jax_frames
from hirest_tpu.infer import custom_video as jax_cv
from hirest_tpu.tokenizers import WordPieceTokenizer as JaxWordPiece
from hirest_tpu.train.trainer import Trainer as JaxTrainer
from hirest_tpu_torch.extraction import frames
from hirest_tpu_torch.infer import custom_video as cv
from hirest_tpu_torch.models.joint import MomentModel
from hirest_tpu_torch.tokenizers import WordPieceTokenizer
from hirest_tpu_torch.train.trainer import Trainer

from torch_port_util import (SERVE_JOINT, TINY_VOCAB, hirest_configs,
                             jax_joint_params, joint_configs,
                             joint_state_dict)

cv2 = pytest.importorskip("cv2")


def make_test_video(path, seconds=8, fps=10, size=64):
    """tests/test_custom_video.py:25-33's synthetic mp4."""
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    w = cv2.VideoWriter(str(path), fourcc, fps, (size, size))
    rng = np.random.default_rng(0)
    for i in range(seconds * fps):
        frame = np.full((size, size, 3), (i * 3) % 255, np.uint8)
        frame += rng.integers(0, 20, frame.shape).astype(np.uint8)
        w.write(frame)
    w.release()


def test_probe_and_annotation_match_jax(tmp_path):
    video = tmp_path / "clip.mp4"
    make_test_video(video)
    dur = cv.probe_duration(str(video))
    assert dur == jax_cv.probe_duration(str(video))
    assert 7.0 <= dur <= 9.0
    for d in (None, 12.6):
        got = cv.build_single_video_annotation(str(video), "test prompt", d)
        assert got == jax_cv.build_single_video_annotation(
            str(video), "test prompt", d)
    assert len(got["test prompt"]["clip.mp4"]["steps"]) == 5
    with pytest.raises(FileNotFoundError):
        cv.probe_duration(str(tmp_path / "missing.mp4"))


@pytest.mark.parametrize("workers", [1, 2])
def test_extract_frames_matches_jax(tmp_path, workers):
    vids = tmp_path / "vids"
    vids.mkdir()
    make_test_video(vids / "a.mp4", seconds=5)
    make_test_video(vids / "b.mp4", seconds=3)
    n = frames.extract_frames(str(vids), str(tmp_path / "port"),
                              num_workers=workers)
    m = jax_frames.extract_frames(str(vids), str(tmp_path / "jax"),
                                  num_workers=1)
    assert n == m == 8
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*.jpg"))
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*.jpg"))
    assert got == want and str(got[0]) == "a/frame_000000.jpg"
    for rel in got:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes())
    # existing outputs are skipped; a subset by id
    assert frames.extract_frames(str(vids), str(tmp_path / "port"),
                                 num_workers=1, video_ids=["b"]) == 3
    assert frames.resolve_frame_dir(tmp_path / "port", "a.mp4") == (
        tmp_path / "port" / "a")


def _text_fn(ids):
    w = np.random.default_rng(7).normal(size=(77, 1024)).astype(np.float32)
    return (np.asarray(ids, np.float32) / 49407.0) @ w


def _fakes(seed):
    """(encode_image_fn, preprocess_fn): seeded random [n, 1024] features
    for each batch, whatever the frames."""
    rng = np.random.default_rng(seed)
    return (lambda imgs: rng.normal(size=(len(imgs), 1024)).astype(
        np.float32),
        lambda img: np.zeros((224, 224, 3), np.float32))


def test_run_custom_video_matches_jax(tmp_path):
    """run_custom_video end to end (annotation, frames of a 30 s mp4, the
    per-video feature finish, the staged MR -> MS -> SC pipeline) with the
    tiny joint model (one seeded state dict in both trainers) and fake
    towers: the same result, and the same frames, features and JSON
    files as the JAX function's."""
    video = tmp_path / "vids" / "clip.mp4"
    video.parent.mkdir()
    # 30 s: with these weights and fakes the moment runs 16 -> 29 and
    # segmentation finds two steps, so all three stages produce output
    make_test_video(video, seconds=30)
    (tmp_path / "vocab.txt").write_text("\n".join(TINY_VOCAB) + "\n")
    vocab = str(tmp_path / "vocab.txt")
    jax_model_cfg, model_cfg = joint_configs(SERVE_JOINT)
    sd = joint_state_dict(SERVE_JOINT)
    runs = {}
    for name in ("jax", "port"):
        work = tmp_path / name
        jax_cfg, cfg = hirest_configs(
            task_moment_retrieval=True, task_moment_segmentation=True,
            task_step_captioning=True, end_to_end=True, eval_batch_size=1,
            num_beams=2, max_words=8, moment_segmentation_max_iterations=4,
            frame_buckets=(64,), data_dir=str(work / "splits"),
            video_feature_dir=str(work / "feats"),
            ckpt_dir=str(work / "out"), pretrained_dir=str(tmp_path / "no"))
        os.makedirs(work / "splits")
        os.makedirs(work / "feats")
        (work / "splits" / "all_data_test.json").write_text("{}")
        if name == "jax":
            trainer = JaxTrainer(jax_cfg, text_encoder_fn=_text_fn,
                                 wordpiece_tokenizer=JaxWordPiece(vocab),
                                 verbose=False, model_config=jax_model_cfg)
            trainer.params = jax_joint_params(sd, SERVE_JOINT)
            run, config = jax_cv.run_custom_video, jax_cfg
        else:
            model = MomentModel(model_cfg)
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in sd.items()})
            trainer = Trainer(cfg, text_encoder_fn=_text_fn,
                              wordpiece_tokenizer=WordPieceTokenizer(vocab),
                              model=model, verbose=False,
                              model_config=model_cfg)
            run, config = cv.run_custom_video, cfg
        encode, preprocess = _fakes(1)
        runs[name] = run(str(video), "demo prompt", config,
                         encode_image_fn=encode, preprocess_fn=preprocess,
                         work_dir=str(work), trainer=trainer)
    got, want = runs["port"], runs["jax"]
    assert got == want
    entry = got["demo prompt"]["clip.mp4"]
    assert "bounds" in entry and entry["steps"]
    files = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        files[name] = {str(p.relative_to(root)): p.read_bytes()
                       for p in sorted(root.rglob("*")) if p.is_file()}
    assert files["port"] == files["jax"]
    assert "out/final_end_to_end_results.json" in files["port"]
    feats = np.load(tmp_path / "port" / "feats" / "clip.mp4.npy")
    assert feats.shape == (30, 1024)
    final = json.loads(files["port"]["out/final_end_to_end_results.json"])
    assert final == json.loads(json.dumps(got))
