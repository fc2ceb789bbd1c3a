"""Serving engine: the resident models behind a request API.

Counterpart of hirest_tpu/serve/engine.py. The reference's closest "serve"
path is a notebook that re-runs run.py end to end per video. This engine
keeps everything resident on the device: the text tower, the joint model
and the trainer's prediction forwards, with a video-embedding index
(mean-pooled features) on the host, so a request is one text encode and a
few device forwards.

Requests run at batch 1, padded to the trainer's frame buckets as in the
JAX engine.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional

import numpy as np

import torch

from hirest_tpu_torch.config import HirestConfig
from hirest_tpu_torch.timeline import frame_index_to_timestamp


class ServingEngine:
    def __init__(self, config: HirestConfig, trainer=None,
                 text_encoder_fn=None, wordpiece_tokenizer=None,
                 index_dir: Optional[str] = None):
        from hirest_tpu_torch.train.trainer import Trainer

        self.config = config
        self.trainer = trainer or Trainer(
            config, text_encoder_fn=text_encoder_fn,
            wordpiece_tokenizer=wordpiece_tokenizer, verbose=False)
        self._lock = threading.Lock()  # device access is serialized

        # retrieval index: mean-pooled, L2-normalized per-video embeddings
        self.video_ids: list[str] = []
        self.video_embeds: Optional[np.ndarray] = None
        if index_dir or config.video_feature_dir:
            self.build_index(index_dir or config.video_feature_dir)

    # -- retrieval index ---------------------------------------------------

    def build_index(self, feature_dir: str, n_model_frames: Optional[int] = None):
        from hirest_tpu_torch.infer.retrieval import encode_videos_from_features

        feature_dir = Path(feature_dir)
        ids = sorted({p.stem for p in feature_dir.iterdir()
                      if p.suffix in (".npy", ".pt", ".npz")})
        if not ids:
            return
        n = n_model_frames if n_model_frames is not None else self.config.n_model_frames
        self.video_embeds = encode_videos_from_features(str(feature_dir), ids, n)
        self.video_ids = ids

    # -- endpoints ----------------------------------------------------------

    def health(self) -> dict:
        dev = self.trainer.device
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        return {"status": "ok",
                "devices": [f"{dev} ({name})"],
                "indexed_videos": len(self.video_ids)}

    def retrieve(self, prompt: str, top_k: int = 10) -> dict:
        """Rank indexed videos for a prompt."""
        if self.video_embeds is None:
            return {"error": "no video index loaded"}
        from hirest_tpu_torch.infer.retrieval import encode_texts

        with self._lock:
            text = encode_texts(self.trainer.text_encoder_fn, [prompt])
        scores = (text @ self.video_embeds.T)[0]
        order = np.argsort(-scores)[:top_k]
        return {"prompt": prompt,
                "videos": [self.video_ids[i] for i in order],
                "scores": [float(scores[i]) for i in order]}

    def analyze(self, prompt: str, video_fname: str,
                video_duration: Optional[float] = None) -> dict:
        """Full hierarchy for one (prompt, video): moment bounds -> step
        segments -> step captions."""
        from hirest_tpu_torch.data.annotations import build_examples, caption_targets
        from hirest_tpu_torch.data.batching import collate

        store = self.trainer.store
        feats = store.visual(video_fname, -1)
        duration = video_duration if video_duration is not None else float(feats.shape[0])

        anns = {prompt: {video_fname: {
            "relevant": True, "clip": True, "v_duration": duration,
            "bounds": [0, int(duration)],
            "steps": [{"index": i, "heading": "", "absolute_bounds": [i, i + 1]}
                      for i in range(5)]}}}

        cfg = self.config
        with self._lock:
            # 1) moment retrieval
            ex = build_examples(anns, "moment_retrieval", cfg.n_model_frames)
            batch = collate(ex, store, self.trainer.buckets)
            arrs = self.trainer._prepare(batch, "moment_retrieval")
            (s, e), = self.trainer._predict_moment_retrieval(arrs)
            if s > e:
                s, e = e, s
            bounds = [frame_index_to_timestamp(int(s), duration, cfg.n_model_frames),
                      frame_index_to_timestamp(int(e), duration, cfg.n_model_frames)]
            anns[prompt][video_fname]["bounds"] = bounds

            # 2) moment segmentation
            ex = build_examples(anns, "moment_segmentation", cfg.n_model_frames,
                                end_to_end=True)
            batch = collate(ex, store, self.trainer.buckets)
            arrs = self.trainer._prepare(batch, "moment_segmentation")
            seg, = self.trainer._predict_moment_segmentation(arrs, batch)
            seg_bounds = [[frame_index_to_timestamp(seg[j], duration, cfg.n_model_frames),
                           frame_index_to_timestamp(seg[j + 1], duration, cfg.n_model_frames)]
                          for j in range(len(seg) - 1)]
            anns[prompt][video_fname]["steps"] = [
                {"index": i, "heading": "", "absolute_bounds": b}
                for i, b in enumerate(seg_bounds)]

            # 3) step captioning
            captions = []
            if seg_bounds:
                ex = build_examples(anns, "step_captioning", cfg.n_model_frames,
                                    end_to_end=True)
                if self.trainer.tokenizer is not None:
                    for x in ex:
                        x.update(caption_targets(self.trainer.tokenizer,
                                                 x["target_text_raw"], cfg.max_words))
                batch = collate(ex, store, self.trainer.buckets)
                arrs = self.trainer._prepare(batch, "step_captioning")
                captions = self.trainer._predict_step_captioning(arrs)

        steps = [{"bounds": b, "caption": captions[i] if i < len(captions) else ""}
                 for i, b in enumerate(seg_bounds)]
        return {"prompt": prompt, "video": video_fname,
                "moment_bounds": bounds, "steps": steps}

    def warmup(self, video_fname: Optional[str] = None) -> dict:
        """Run each endpoint once so first requests find warm caches."""
        out = {"retrieve": False, "analyze": False}
        if self.video_ids:
            self.retrieve("warmup prompt", top_k=1)
            out["retrieve"] = True
            vid = video_fname or f"{self.video_ids[0]}"
            # feature files may be keyed by raw stem (this repo's extractor)
            # or with the container suffix (reference naming): try the id
            # as indexed FIRST, then the suffixed form
            for cand in ([vid] if vid.endswith(".mp4")
                         else [vid, vid + ".mp4"]):
                try:
                    self.analyze("warmup prompt", cand)
                    out["analyze"] = True
                    break
                except FileNotFoundError:
                    continue
        return out
