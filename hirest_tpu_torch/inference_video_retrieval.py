"""Zero-shot video retrieval with the flags of the reference
inference_video_retrieval.py (the root script of the JAX package):

    python -m hirest_tpu_torch.inference_video_retrieval
        --data_dir data/splits --video_feature_dir feats/
        [--video_retrieval_model clip_g|clip] [--raw_frame --video_dir frames/]
        [--n_model_frames 32] [--fp16] [--run_name NAME]
        [--pretrained_dir ./pretrained_weights] [--load ViT-B-32.pt]
        [--device cuda|cpu]

`clip_g` encodes prompts with the EVA-CLIP-g text tower
(`eva_clip_psz14.pt` in --pretrained_dir) and, with --raw_frame, frames
with the unrolled EVA-g vision tower (`build_unrolled_vision_apply`; its
attention is K6); otherwise videos come from their feature files. `clip`
uses OpenAI CLIP ViT-B/32 (--load, else `ViT-B-32.pt` in --pretrained_dir:
the text tower and the class-token vision head). A missing checkpoint
gives seeded random weights, with a warning. --fp16 selects bf16, else
f32. It scores text @ video.T and writes VR_results/{run_name}.json.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from hirest_tpu_torch.config import HirestConfig


def _build_towers(config: HirestConfig, device: torch.device):
    """(encode_text(ids), encode_image(frames) or None) on `device`."""
    from hirest_tpu_torch.models.convert import load_torch_ckpt

    dtype = torch.bfloat16 if config.fp16 else torch.float32
    encode_image = None
    if config.video_retrieval_model == "clip":
        from hirest_tpu_torch.models.openai_clip import load_clip_towers
        from hirest_tpu_torch.utils.init import random_clip_state_dict

        ckpt = config.load or os.path.join(config.pretrained_dir,
                                           "ViT-B-32.pt")
        if os.path.exists(ckpt):
            sd = load_torch_ckpt(ckpt)
            print(f"Loaded CLIP ViT-B/32 from {ckpt}")
        else:
            sd = random_clip_state_dict(seed=0)
            print(f"WARNING: {ckpt} not found - using random-init CLIP")
        text, vision = load_clip_towers(sd, device=device, dtype=dtype)

        @torch.inference_mode()
        def encode_text(ids) -> torch.Tensor:
            return text(torch.as_tensor(ids).to(device))

        if config.raw_frame:
            @torch.inference_mode()
            def encode_image(images) -> torch.Tensor:
                return vision(torch.as_tensor(images).to(device))
        return encode_text, encode_image

    if config.video_retrieval_model != "clip_g":
        raise ValueError(f"unknown --video_retrieval_model "
                         f"{config.video_retrieval_model!r}: clip_g or clip")
    from hirest_tpu_torch.config import EvaTextConfig, EvaVisionConfig
    from hirest_tpu_torch.models.convert import eva_vision_state_dict
    from hirest_tpu_torch.models.eva_clip import (build_unrolled_vision_apply,
                                                  eva_text_encoder)
    from hirest_tpu_torch.utils.init import (random_eva_text_state_dict,
                                             random_eva_vision_state_dict)

    ckpt = os.path.join(config.pretrained_dir, "eva_clip_psz14.pt")
    if os.path.exists(ckpt):
        sd = load_torch_ckpt(ckpt)
        print("Loaded EVA CLIP G")
    else:
        sd = {f"text.{k}": v for k, v in
              random_eva_text_state_dict(EvaTextConfig(), seed=0).items()}
        print(f"WARNING: {ckpt} not found - using random-init text tower")
    encode_text = eva_text_encoder(sd, EvaTextConfig(), dtype, device)
    if config.raw_frame:
        vision_sd = (eva_vision_state_dict(sd)
                     if any(k.startswith("visual.") for k in sd)
                     else random_eva_vision_state_dict(EvaVisionConfig(),
                                                       seed=0))
        encode_image = build_unrolled_vision_apply(
            vision_sd, EvaVisionConfig(), dtype=dtype, device=device)
    return encode_text, encode_image


def main(argv=None) -> dict:
    """Parse the flags (argv, else the command line), run the retrieval on
    --device (CUDA unless "cpu" is asked for) and return the result dict
    it writes."""
    from hirest_tpu_torch.infer.retrieval import run_video_retrieval
    from hirest_tpu_torch.models.eva_clip import preprocess_image
    from hirest_tpu_torch.utils.device import resolve_device

    config = HirestConfig.from_args(argv)
    random.seed(config.seed)
    np.random.seed(config.seed)
    device = resolve_device(config.device)
    encode_text, encode_image = _build_towers(config, device)
    return run_video_retrieval(config, encode_text, encode_image,
                               preprocess_image if config.raw_frame else None)


if __name__ == "__main__":
    main()
