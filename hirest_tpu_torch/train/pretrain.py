"""Caption-generator pretraining (the CLIP4Caption stage).

Counterpart of hirest_tpu/train/pretrain.py (reference
clip4caption/train.py:41-509 and dataloaders/dataloader_hodini_feats.py,
which retargets it at HiREST step annotations): one loop over (video
features, caption) pairs,

    features [T, D] --NormalizeVideo LN--> VisualEncoder --> CaptionDecoder
    teacher-forced CE (PAD positions included, as the reference's
    CrossEntropyLoss(ignore_index=-1) on 0-padded targets)

with BertAdam. `CaptionGenerator` carries the reference's (and the joint
model's `clip4cap_model.*`) names, so `init_moment_model_from_pretrain`
loads its three parts into a MomentModel. As in the JAX loop, the model
trains without dropout (its CaptionGenerator is deterministic).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from hirest_tpu_torch.config import DecoderConfig, VisualEncoderConfig
from hirest_tpu_torch.models.caption import CaptionDecoder, VisualEncoder
from hirest_tpu_torch.models.layers import layer_norm_fast_var
from hirest_tpu_torch.native import trim_to_moment
from hirest_tpu_torch.train.losses import step_captioning_loss
from hirest_tpu_torch.train.optim import apply_updates, bert_adam, grads_of
from hirest_tpu_torch.utils.device import resolve_device
from hirest_tpu_torch.utils.init import _draw


class CaptionGenerator(nn.Module):
    """Standalone encoder + decoder captioner (reference
    clip4caption/modules/modeling.py:108-215): a LayerNorm front end
    (NormalizeVideo) over `in_dim`-wide features, the BERT-style visual
    encoder and the tied-classifier decoder."""

    def __init__(self, visual: VisualEncoderConfig = VisualEncoderConfig(),
                 decoder_cfg: DecoderConfig = DecoderConfig(),
                 dtype: torch.dtype = torch.float32,
                 in_dim: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.normalize_video = nn.ModuleDict({"visual_norm2d": nn.LayerNorm(
            in_dim or visual.feature_dim, eps=1e-12)})
        self.visual = VisualEncoder(visual, dtype, in_dim=in_dim)
        self.decoder = CaptionDecoder(decoder_cfg, dtype)

    def encode(self, video_feats: torch.Tensor) -> torch.Tensor:
        x = layer_norm_fast_var(video_feats.to(self.dtype),
                                self.normalize_video["visual_norm2d"])
        return self.visual(x)

    def forward(self, video_feats, input_ids, answer_mask=None):
        return self.decoder(input_ids, self.encode(video_feats),
                            answer_mask=answer_mask)


def build_pretrain_examples(annotations: dict, store, tokenizer,
                            max_words: int, max_frames: int) -> list[dict]:
    """HiREST step annotations -> (trimmed features, caption targets)
    pairs (the dataloader_hodini_feats.py retargeting)."""
    from hirest_tpu_torch.data.annotations import (build_examples,
                                                   caption_targets)

    out = []
    for e in build_examples(annotations, "step_captioning"):
        feats = store.visual(e["fname"], e["n_model_frames"])
        # reconcile the mask with the feature length both ways: feature
        # files often have a few more rows than int(v_duration), all
        # outside the annotated moment
        mm = np.asarray(e["moment_mask"])[: feats.shape[0]]
        if mm.shape[0] < feats.shape[0]:
            mm = np.pad(mm, (0, feats.shape[0] - mm.shape[0]))
        if mm.sum() == 0:
            continue
        d = caption_targets(tokenizer, e["target_text_raw"], max_words)
        d["vis_feats"] = trim_to_moment(feats, mm, max_frames)
        d["caption"] = e["target_text_raw"]
        out.append(d)
    return out


def _decays(name: str) -> bool:
    """The JAX loop's weight-decay mask on the port's names: no decay for
    a bias leaf or a LayerNorm tensor (reference clip4caption/train.py:
    196-211). The classifier's vocabulary bias is JAX's `cls_bias`, a leaf
    of its own name, which that mask decays."""
    if name.endswith("cls.predictions.bias"):
        return True
    return not (name.endswith(".bias") or "LayerNorm" in name)


def pretrain_caption_generator(
    examples: list[dict],
    visual_cfg: VisualEncoderConfig = VisualEncoderConfig(),
    decoder_cfg: DecoderConfig = DecoderConfig(),
    batch_size: int = 32,
    epochs: int = 5,
    lr: float = 1e-4,
    warmup: float = 0.1,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
) -> CaptionGenerator:
    """Train the captioner, from seeded random weights (`seed`), on
    `device` (CUDA unless "cpu"); returns it. Batches follow numpy's
    default_rng(seed) permutation an epoch, the last partial batch
    dropped, as the JAX loop does."""
    device = resolve_device(device)
    in_dim = np.asarray(examples[0]["vis_feats"]).shape[-1]
    with torch.device("meta"):
        model = CaptionGenerator(visual_cfg, decoder_cfg, in_dim=in_dim)
    sd = _draw({k: tuple(v.shape) for k, v in model.state_dict().items()},
               seed, ("LayerNorm.weight", "visual_norm2d.weight"))
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in sd.items()}, assign=True)
    model = model.to(device).eval()
    params = dict(model.named_parameters())

    steps_per_epoch = max(1, len(examples) // batch_size)
    # BertAdam with warmup_linear, the upstream pretrain's optimizer
    tx = bert_adam(lr, warmup=warmup, t_total=steps_per_epoch * epochs,
                   schedule="warmup_linear", max_grad_norm=1.0,
                   decay_mask={k: _decays(k) for k in params})
    opt_state = tx.init(params)

    def stack(chunk, key):
        return torch.as_tensor(np.stack([c[key] for c in chunk])).to(device)

    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = rng.permutation(len(examples))
        losses = []
        for i in range(0, len(order) - batch_size + 1, batch_size):
            chunk = [examples[j] for j in order[i: i + batch_size]]
            model.zero_grad(set_to_none=True)
            logits = model(stack(chunk, "vis_feats"),
                           stack(chunk, "input_caption_ids"),
                           stack(chunk, "decoder_mask"))
            loss = step_captioning_loss(logits,
                                        stack(chunk, "output_caption_ids"))
            loss.backward()
            with torch.no_grad():
                updates, opt_state = tx.update(grads_of(params), opt_state,
                                               params)
                apply_updates(params, updates)
            losses.append(loss.detach())
        if verbose:
            mean = float(torch.stack(losses).mean()) if losses else 0.0
            print(f"pretrain epoch {epoch}: loss {mean:.4f}")
    model.zero_grad(set_to_none=True)

    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, "caption_pretrain.pt")
        torch.save(model.state_dict(), path)
        if verbose:
            print("Saved", path)
    return model


def init_moment_model_from_pretrain(model: nn.Module,
                                    generator: CaptionGenerator) -> nn.Module:
    """Load a pretrained CaptionGenerator's video LayerNorm, encoder and
    decoder into a MomentModel (`clip4cap_model.*`); shapes must match."""
    parts = model.clip4cap_model
    for name in ("normalize_video", "visual", "decoder"):
        parts[name].load_state_dict(getattr(generator, name).state_dict())
    return model
