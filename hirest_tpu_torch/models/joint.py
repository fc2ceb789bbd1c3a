"""The joint multitask model: shared trunk and task heads, in PyTorch.

Counterpart of hirest_tpu/models/joint.py (flax `MomentModel`), with the
same arithmetic and the reference's parameter names (modeling.py:18-123):
`temporal_embed.0/2`, `mask_embed`, `boundary_embed`, `clip_g_map`,
`clip_g_map_text`, `clip4cap_model.normalize_video.visual_norm2d`,
`clip4cap_model.visual.*`, `clip4cap_model.decoder.*`,
`{start,end,segment}_predictor.0` and, with ASR, `asr_enc_layer.0/1` (the
JAX module's `asr_norm` and `asr_proj`). A reference `.pth` loads through
models/convert.py::load_moment_state_dict.

As in the JAX package, the frozen EVA-CLIP text tower is not a submodule:
the trunk consumes the pooled text feature [B, 1024].

Trunk math (modeling.py:155-210), in order:
  video [B,T,1024] -> clip_g_map -> LayerNorm(normalize_video)
  text  [B,1024]   -> clip_g_map_text -> L2 normalize
  feats = video * text[:, None]          (query gating)
  += asr_enc_layer(asr)  [optional]
  += boundary_embed(boundary_mask)  [segmentation only]
  += temporal_embed(normalized time in [-1,1], 0 on padding)
  += mask_embed(moment_mask)
  -> VisualEncoder (full attention) -> [B, T, 768]

Parameters stay f32 and the model computes in `dtype` (f32, or bf16 with
the config's fp16), as the flax module does with `dtype`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hirest_tpu_torch.config import JointModelConfig
from hirest_tpu_torch.models.caption import CaptionDecoder, VisualEncoder
from hirest_tpu_torch.models.layers import dense, layer_norm_fast_var


class MomentModel(nn.Module):
    def __init__(self, config: JointModelConfig = JointModelConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        d = cfg.embed_dim
        if cfg.use_asr:  # [asr_norm, asr_proj]
            self.asr_enc_layer = nn.Sequential(
                nn.LayerNorm(cfg.asr_dim, eps=1e-5), nn.Linear(cfg.asr_dim, d))
        self.temporal_embed = nn.Sequential(nn.Linear(1, d), nn.Tanh(),
                                            nn.Linear(d, d))
        self.mask_embed = nn.Embedding(2, d)
        self.boundary_embed = nn.Embedding(2, d)
        self.clip_g_map = nn.Linear(cfg.clip_dim, d)
        self.clip_g_map_text = nn.Linear(cfg.clip_dim, d)
        self.clip4cap_model = nn.ModuleDict({
            "normalize_video": nn.ModuleDict(
                {"visual_norm2d": nn.LayerNorm(d, eps=1e-12)}),
            "visual": VisualEncoder(cfg.visual, dtype, in_dim=d),
            "decoder": CaptionDecoder(cfg.decoder, dtype)})
        # the heads read the encoder's width (trunk_dim in the default
        # config), which the flax Dense infers from its input
        h = cfg.visual.hidden_size
        self.start_predictor = nn.Sequential(nn.Linear(h, 1))
        self.end_predictor = nn.Sequential(nn.Linear(h, 1))
        self.segment_predictor = nn.Sequential(nn.Linear(h, 1))

    @property
    def encoder(self) -> VisualEncoder:
        return self.clip4cap_model["visual"]

    @property
    def decoder(self) -> CaptionDecoder:
        return self.clip4cap_model["decoder"]

    def _embed(self, table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        return table.weight.to(self.dtype)[ids.long()]

    # -- shared trunk ---------------------------------------------------

    def trunk(self, video_feats, text_feat, video_mask=None, moment_mask=None,
              asr_feats=None, boundary_mask=None):
        """video_feats [B,T,1024], text_feat [B,1024] -> [B,T,768]."""
        b, t, _ = video_feats.shape
        dt, dev = self.dtype, video_feats.device
        if video_mask is None:
            video_mask = torch.ones(b, t, dtype=torch.int32, device=dev)
        if moment_mask is None:
            moment_mask = torch.ones(b, t, dtype=torch.int32, device=dev)

        video = dense(video_feats.to(dt), self.clip_g_map)
        video = layer_norm_fast_var(
            video, self.clip4cap_model["normalize_video"]["visual_norm2d"])
        text = dense(text_feat.to(dt), self.clip_g_map_text)
        text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
        feats = video * text[:, None, :]

        if self.config.use_asr and asr_feats is not None:
            norm, proj = self.asr_enc_layer
            feats = feats + dense(layer_norm_fast_var(asr_feats.to(dt), norm),
                                  proj)
        if boundary_mask is not None:
            feats = feats + self._embed(self.boundary_embed, boundary_mask)

        # per-sample normalized time: position i of a sample with n valid
        # frames gets (i/(n-1) - 0.5) * 2, padding positions get 0
        # (modeling.py:182-196)
        n_frames = video_mask.sum(-1)
        idx = torch.arange(t, dtype=torch.float32, device=dev)[None, :]
        denom = torch.clamp_min(n_frames - 1, 1).float()[:, None]
        times = (idx / denom - 0.5) * 2.0
        times = torch.where(video_mask.bool(), times, 0.0)
        fc1, fc2 = self.temporal_embed[0], self.temporal_embed[2]
        temb = dense(torch.tanh(dense(times[..., None].to(dt), fc1)), fc2)
        feats = feats + temb
        feats = feats + self._embed(self.mask_embed, moment_mask)
        return self.encoder(feats)

    # -- task forwards --------------------------------------------------

    def moment_retrieval(self, video_feats, text_feat, video_mask=None,
                         moment_mask=None, asr_feats=None) -> dict:
        feats = self.trunk(video_feats, text_feat, video_mask,
                           moment_mask=moment_mask, asr_feats=asr_feats)
        return {"start_logits": self._head(self.start_predictor, feats),
                "end_logits": self._head(self.end_predictor, feats)}

    def moment_segmentation(self, video_feats, text_feat, video_mask,
                            moment_mask, asr_feats=None, boundary_mask=None):
        feats = self.trunk(video_feats, text_feat, video_mask,
                           moment_mask=moment_mask, asr_feats=asr_feats,
                           boundary_mask=boundary_mask)
        return self._head(self.segment_predictor, feats)

    @staticmethod
    def _head(predictor: nn.Sequential, feats: torch.Tensor) -> torch.Tensor:
        return dense(feats, predictor[0]).squeeze(-1).float()

    def caption_encode(self, video_feats, text_feat, asr_feats=None):
        """Trunk over moment-trimmed features, every mask 1 (modeling.py:
        513-514): [B, max_frames, 1024] -> [B, max_frames, 768]."""
        b, t, _ = video_feats.shape
        ones = torch.ones(b, t, dtype=torch.int32, device=video_feats.device)
        return self.trunk(video_feats, text_feat, video_mask=ones,
                          moment_mask=ones, asr_feats=asr_feats)

    def caption_logits(self, visual_output, input_caption_ids,
                       decoder_mask: Optional[torch.Tensor] = None):
        """Teacher-forced decoder scores [B, L, V] (modeling.py:516-517)."""
        return self.decoder(input_caption_ids, visual_output,
                            answer_mask=decoder_mask)

    def forward(self, video_feats, text_feat, video_mask=None,
                moment_mask=None, asr_feats=None) -> dict:
        """The default forward is moment retrieval, as the JAX module's."""
        return self.moment_retrieval(video_feats, text_feat, video_mask,
                                     moment_mask, asr_feats)
