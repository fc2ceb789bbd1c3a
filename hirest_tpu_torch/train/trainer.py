"""The inference half of the multitask engine.

Counterpart of hirest_tpu/train/trainer.py::Trainer, under the same name so
that the serving engine reads like the JAX one: the joint model, the frozen
EVA-CLIP text tower, the feature store, the frame buckets, the batch
preparation and the three prediction forwards (moment retrieval, iterative
moment segmentation, step captioning with the KV-cached beam). Training,
`predict`/`evaluate` over a split and the checkpoint round trip are not
ported yet.

Everything runs on `config.device`: CUDA unless "cpu" is asked for, never
a fallback. The host keeps the data-dependent parts the JAX package keeps
there: the moment trim of step captioning and, unless
`fused_segmentation`, the greedy walk of segmentation.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from hirest_tpu_torch.config import EvaTextConfig, HirestConfig
from hirest_tpu_torch.data.features import FeatureStore
from hirest_tpu_torch.infer.beam import beam_search_cached
from hirest_tpu_torch.infer.segmentation import (iterative_segmentation,
                                                 iterative_segmentation_scan)
from hirest_tpu_torch.models.joint import MomentModel
from hirest_tpu_torch.native import trim_to_moment
from hirest_tpu_torch.tokenizers import clip_tokenize
from hirest_tpu_torch.utils.device import resolve_device

BOS_ID, EOS_ID = 101, 102  # BERT [CLS] / [SEP]


class Trainer:
    def __init__(
        self,
        config: HirestConfig,
        text_encoder_fn: Optional[Callable] = None,
        wordpiece_tokenizer=None,
        model: Optional[MomentModel] = None,
        feature_store: Optional[FeatureStore] = None,
        verbose: bool = True,
        model_config=None,
    ):
        self.config = config
        self.verbose = verbose
        self.device = resolve_device(config.device)
        self.model_cfg = model_config or config.joint_model_config()
        self.dtype = torch.bfloat16 if config.fp16 else torch.float32
        self.tokenizer = wordpiece_tokenizer
        vocab = getattr(wordpiece_tokenizer, "vocab", None)
        self.bos_id = vocab["[CLS]"] if vocab else BOS_ID
        self.eos_id = vocab["[SEP]"] if vocab else EOS_ID
        self.text_encoder_fn = text_encoder_fn or self._make_text_encoder()
        self.store = feature_store or FeatureStore(
            config.video_feature_dir or None, config.asr_dir,
            config.asr_feature_dir)
        self.buckets = tuple(config.frame_buckets)
        self.model = (model or self._init_params()).to(self.device).eval()

    # -- construction ----------------------------------------------------

    def _make_text_encoder(self):
        """The EVA-CLIP text tower as a frozen feature function on the
        device. Loads `eva_clip_psz14.pt` from pretrained_dir when present;
        otherwise seeded random weights (for tests and scratch runs, loudly
        warned)."""
        from hirest_tpu_torch.models.convert import load_torch_ckpt
        from hirest_tpu_torch.models.eva_clip import eva_text_encoder
        from hirest_tpu_torch.utils.init import random_eva_text_state_dict

        text_cfg = EvaTextConfig()
        ckpt = os.path.join(self.config.pretrained_dir, "eva_clip_psz14.pt")
        if os.path.exists(ckpt):
            sd = load_torch_ckpt(ckpt)
            if self.verbose:
                print(f"Loaded EVA-CLIP text tower from {ckpt}")
        else:
            sd = random_eva_text_state_dict(text_cfg, seed=0)
            print(f"WARNING: {ckpt} not found - EVA text tower is "
                  f"random-init")
        return eva_text_encoder(sd, text_cfg, self.dtype, self.device)

    def _init_params(self) -> MomentModel:
        """The joint model with seeded random weights (config.seed), its
        encoder and decoder overwritten by the pretrained CLIP4Caption
        weights when present (modeling.py:102-110)."""
        from hirest_tpu_torch.models.convert import (init_from_clip4caption,
                                                     load_torch_ckpt)
        from hirest_tpu_torch.utils.init import random_moment_state_dict

        with torch.device("meta"):
            model = MomentModel(self.model_cfg, dtype=self.dtype)
        sd = random_moment_state_dict(self.model_cfg, seed=self.config.seed)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                              assign=True)
        bin_path = os.path.join(self.config.pretrained_dir,
                                "clip4caption_vit-b-32_model.bin")
        if os.path.exists(bin_path):
            init_from_clip4caption(model, load_torch_ckpt(bin_path))
            if self.verbose:
                print(f"Initialized encoder/decoder from {bin_path}")
        return model

    # -- batch prep -------------------------------------------------------

    def _prepare(self, batch: dict, task: str) -> dict:
        """Host batch dict -> tensors on the device (with the text encode
        and the step-captioning moment trim). Prompts are repeat-padded to
        the array batch rows where the batch was padded (batch_mask)."""
        n_real = len(batch["prompts"])
        n_rows = len(batch["batch_mask"]) if "batch_mask" in batch else n_real
        prompts = (list(batch["prompts"])
                   + [batch["prompts"][0]] * (n_rows - n_real))
        text_feat = self.text_encoder_fn(clip_tokenize(prompts))

        def dev(a):
            return torch.as_tensor(np.asarray(a)).to(self.device)

        arrs = {"text_feat": torch.as_tensor(text_feat, dtype=torch.float32,
                                             device=self.device)}
        if task == "step_captioning":
            mf = self.config.max_frames_step_captioning
            keys = ["vis_feats"] + (["asr_feats"] if "asr_feats" in batch
                                    else [])
            for key in keys:
                arrs[key] = dev(np.stack([
                    trim_to_moment(batch[key][i], batch["moment_mask"][i], mf)
                    for i in range(n_rows)]))
            extra = ("input_caption_ids", "output_caption_ids",
                     "decoder_mask")
        else:
            extra = ("vis_feats", "video_mask", "moment_mask", "asr_feats",
                     "moment_retrieval_start_target",
                     "moment_retrieval_end_target",
                     "moment_segmentation_target", "prev_boundary_mask")
        for key in extra + ("batch_mask",):
            if key in batch:
                arrs[key] = dev(batch[key])
        return arrs

    # -- prediction forwards ---------------------------------------------

    @torch.inference_mode()
    def _predict_moment_retrieval(self, arrs) -> list:
        out = self.model.moment_retrieval(
            arrs["vis_feats"], arrs["text_feat"], arrs["video_mask"],
            arrs["moment_mask"], arrs.get("asr_feats"))
        valid = arrs["video_mask"] > 0
        start = torch.where(valid, out["start_logits"], -1e10)
        end = torch.where(valid, out["end_logits"], -1e10)
        return torch.stack([start.argmax(1), end.argmax(1)], 1).cpu().tolist()

    def _segment_scores(self, arrs, moment_mask, prev_boundary_mask):
        logits = self.model.moment_segmentation(
            arrs["vis_feats"], arrs["text_feat"], arrs["video_mask"],
            moment_mask, arrs.get("asr_feats"), prev_boundary_mask)
        masked = torch.where(moment_mask > 0, logits,
                             -torch.finfo(torch.float32).max)
        return torch.softmax(masked, dim=1)

    @torch.inference_mode()
    def _predict_moment_segmentation(self, arrs, batch) -> list:
        cfg = self.config
        t = arrs["vis_feats"].shape[1]
        bounds = np.asarray(batch["moment_bound_frames"])
        if cfg.fused_segmentation:
            # the whole loop on the device, one fetch at the end
            return iterative_segmentation_scan(
                lambda mm, pbm: self._segment_scores(arrs, mm, pbm), bounds,
                t, cfg.moment_segmentation_difference_threshold,
                cfg.moment_segmentation_max_iterations, device=self.device)

        def score_fn(mm, pbm):
            mm, pbm = (torch.from_numpy(mm).to(self.device),
                       torch.from_numpy(pbm).to(self.device))
            return self._segment_scores(arrs, mm, pbm).cpu().numpy()

        return iterative_segmentation(
            score_fn, bounds, t, cfg.moment_segmentation_difference_threshold,
            cfg.moment_segmentation_max_iterations)

    @torch.inference_mode()
    def _predict_step_captioning(self, arrs) -> list:
        cfg = self.config
        beam, max_words = cfg.num_beams, cfg.max_words
        b = arrs["vis_feats"].shape[0]
        vis = self.model.caption_encode(arrs["vis_feats"], arrs["text_feat"],
                                        arrs.get("asr_feats"))
        dec = self.model.decoder
        cross_kv = dec.cross_kv(vis.repeat_interleave(beam, dim=0))

        def step_fn(last, t, cache):
            return dec.decode_step(last, t, cross_kv, cache)

        def gather_fn(cache, src):
            return tuple((k[src], v[src]) for k, v in cache)

        ids, _ = beam_search_cached(
            step_fn, gather_fn, dec.init_cache(b * beam, max_words + 1), b,
            beam, max_words, self.bos_id, self.eos_id, device=self.device)
        out = []
        for row in ids.cpu().numpy():
            if self.tokenizer is not None:
                from hirest_tpu_torch.tokenizers.wordpiece import \
                    detokenize_caption

                toks = self.tokenizer.convert_ids_to_tokens(
                    [int(x) for x in row])
                out.append(detokenize_caption(toks))
            else:
                out.append(" ".join(str(int(x)) for x in row if x != 0))
        return out

    # -- checkpoints -------------------------------------------------------

    def load_torch_checkpoint(self, ckpt_path: str):
        """Load a reference-format .pth joint checkpoint (its key surgery
        included) into the model."""
        from hirest_tpu_torch.models.convert import (load_moment_state_dict,
                                                     load_torch_ckpt)

        self.model = load_moment_state_dict(
            self.model, load_torch_ckpt(ckpt_path)).to(self.device)
        if self.verbose:
            print("Model loaded from", ckpt_path)
