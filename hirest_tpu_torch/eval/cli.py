"""Evaluation CLI, the flags of the reference evaluate.py:414-501.

Counterpart of hirest_tpu/eval/cli.py; run as `python -m
hirest_tpu_torch.evaluate`:

    python -m hirest_tpu_torch.evaluate
        --task {video_retrieval,moment_retrieval,moment_segmentation,
                step_captioning}
        --pred_data PRED.json [--gt_data GT.json] [--print_per_category]
        [--preprocess_moment_bounds] [--replace_pred_moment_bounds]
        [--frame_dir DIR] [--data_root ./data] [--meteor_version 1.5]
        [--device cuda]

Step captioning's model-backed scores read `./pretrained_weights`, relative
to the working directory, as the reference and the JAX CLI do:
`ViT-B-32.pt` (CLIPScore, with --frame_dir), `vocab.txt` with
`bertscore.bin` or `bert-base-uncased.bin` (12 x 768 x 3072) or
`all-MiniLM-L6-v2.bin` (BERTScore), and `nli/` (config.json with its
id2label, vocab.txt and model.safetensors, pytorch_model.bin, model.bin
or model.pt: Entailment). A score whose files are missing is left out,
loudly. The models run on `--device`, the metrics on the host.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from hirest_tpu_torch.eval.captions import evaluate_step_captions
from hirest_tpu_torch.eval.metrics import (
    Categories,
    compute_step_bound_scores,
    evaluate_moment_retrieval,
    evaluate_video_retrieval,
    preprocess_moment_bounds,
)

DEFAULT_DATA_ROOT = "./data"
PRETRAINED_DIR = "./pretrained_weights"


def parse_device(spec) -> str:
    """--device as a torch device string: "cuda", "cpu" and "cuda:N" as
    they are; an integer in the reference's spelling, N >= 0 -> "cuda:N",
    -1 -> "cpu" (allennlp's cuda_device=-1)."""
    text = str(spec).strip()
    try:
        n = int(text)
    except ValueError:
        return text
    if n < -1:
        raise ValueError(f"--device {n}: an integer device is >= 0, or -1 "
                         f"for the CPU")
    return "cpu" if n == -1 else f"cuda:{n}"


def get_eval_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Run experiment", add_help=False)
    parser.add_argument("--task", type=str, required=True)
    parser.add_argument("--gt_data", type=str, required=False)
    parser.add_argument("--pred_data", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the scoring models run: 'cuda' (the "
                             "default), 'cpu', 'cuda:N', or an integer as "
                             "the reference spells it (N >= 0 is cuda:N, "
                             "-1 the CPU). Without a GPU it raises unless "
                             "the CPU is asked for")
    parser.add_argument("--print_per_category", action="store_true")
    parser.add_argument("--help", action="store_true")
    parser.add_argument("--preprocess_moment_bounds", action="store_true")
    parser.add_argument("--replace_pred_moment_bounds", action="store_true")
    parser.add_argument("--frame_dir", type=str, default="None")
    parser.add_argument("--data_root", type=str, default=DEFAULT_DATA_ROOT,
                        help="root containing splits/ and evaluation/ "
                             "(an extension of the JAX package)")
    parser.add_argument("--meteor_version", type=str, default="1.5",
                        choices=["1.5", "2005"],
                        help="METEOR scoring model; the reference scores "
                             "captions with the METEOR-1.5 jar, so 1.5 is "
                             "the parity default (an extension of the JAX "
                             "package)")
    return parser


def _try_build_clipscore(frame_dir: str, pretrained_dir: str = PRETRAINED_DIR,
                         device=None):
    """CLIPScore on the port's CLIP ViT-B/32 in f32 (the reference,
    evaluate.py:204-268, uses torch CLIP ViT-B/32), or None when the
    checkpoint is missing."""
    ckpt = os.path.join(pretrained_dir, "ViT-B-32.pt")
    if not os.path.exists(ckpt):
        print(f"CLIPScore disabled: {ckpt} not found")
        return None
    import torch
    from PIL import Image

    from hirest_tpu_torch.eval.captions import make_clipscore_fn
    from hirest_tpu_torch.models.convert import load_torch_ckpt
    from hirest_tpu_torch.models.eva_clip import preprocess_image
    from hirest_tpu_torch.models.openai_clip import load_clip_towers
    from hirest_tpu_torch.tokenizers import clip_tokenize
    from hirest_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    text, vision = load_clip_towers(load_torch_ckpt(ckpt), device=device)

    @torch.inference_mode()
    def encode_image(images) -> np.ndarray:
        return vision(torch.as_tensor(images).to(device)).cpu().numpy()

    @torch.inference_mode()
    def encode_text(texts) -> np.ndarray:
        ids = torch.as_tensor(clip_tokenize(texts)).to(device)
        return text(ids).cpu().numpy()

    return make_clipscore_fn(
        frame_dir, encode_image_fn=encode_image, encode_text_fn=encode_text,
        preprocess_fn=lambda path: preprocess_image(Image.open(path)))


def _try_build_bertscore(pretrained_dir: str = PRETRAINED_DIR, device=None):
    """BERTScore on the port's BERT encoder when a local checkpoint and
    vocab.txt exist, else None."""
    vocab = os.path.join(pretrained_dir, "vocab.txt")
    for name in ("bertscore.bin", "bert-base-uncased.bin",
                 "all-MiniLM-L6-v2.bin"):
        ckpt = os.path.join(pretrained_dir, name)
        if os.path.exists(ckpt) and os.path.exists(vocab):
            from hirest_tpu_torch.eval.bertscore import make_bertscore_fn
            from hirest_tpu_torch.models.minilm import MiniLmConfig

            cfg = (MiniLmConfig(hidden_size=768, num_hidden_layers=12,
                                intermediate_size=3072)
                   if "bert-base" in name or name == "bertscore.bin"
                   else MiniLmConfig())
            return make_bertscore_fn(ckpt, vocab, config=cfg, device=device)
    print("BERTScore disabled: no local BERT checkpoint in", pretrained_dir)
    return None


def _try_build_entailment(pretrained_dir: str = PRETRAINED_DIR, device=None):
    """Entailment scorer (reference evaluate.py:197-201): the port's NLI
    cross-encoder for BERT-architecture checkpoints, else the transformers
    plugin for other architectures (RoBERTa/DeBERTa NLI), else None."""
    nli_dir = os.path.join(pretrained_dir, "nli")
    if os.path.isdir(nli_dir):
        try:
            from hirest_tpu_torch.models.nli import make_nli_entailment_fn

            return make_nli_entailment_fn(nli_dir, device=device)
        except (ValueError, FileNotFoundError, KeyError) as e:
            print(f"the port's NLI path cannot read {nli_dir} ({e}); trying "
                  f"the transformers plugin")
            from hirest_tpu_torch.eval.bertscore import make_hf_entailment_fn

            return make_hf_entailment_fn(nli_dir)
    print("Entailment disabled: no NLI model at", nli_dir)
    return None


def main(argv=None) -> dict:
    from hirest_tpu_torch.utils.device import resolve_device

    args = get_eval_parser().parse_args(argv)
    print(args)
    device = resolve_device(parse_device(args.device))

    splits_gt = os.path.join(args.data_root, "splits/all_data_test.json")
    moment_gt = os.path.join(args.data_root, "evaluation/formatted_moment_evaluation_gt.json")
    category_path = os.path.join(args.data_root, "evaluation/categories.json")

    pred_data = args.pred_data
    if args.preprocess_moment_bounds:
        if args.gt_data is None:
            args.gt_data = moment_gt
        new_pred = preprocess_moment_bounds(args.gt_data, args.pred_data)
        if args.replace_pred_moment_bounds:
            if not isinstance(args.pred_data, str):
                raise ValueError("--replace_pred_moment_bounds needs a path "
                                 "to the source file")
            with open(args.pred_data, "w") as f:
                json.dump(new_pred, f)
        pred_data = new_pred

    categories = Categories.load(category_path) if os.path.exists(category_path) else Categories.single()

    if args.help:
        print("Please see the 'examples_for_evaluation_folder' for input examples")
        return {}

    clipscore_fn = bertscore_fn = entailment_fn = None
    if args.task == "step_captioning":
        if args.frame_dir != "None":
            clipscore_fn = _try_build_clipscore(args.frame_dir, device=device)
        bertscore_fn = _try_build_bertscore(device=device)
        entailment_fn = _try_build_entailment(device=device)

    if args.task == "video_retrieval":
        result = evaluate_video_retrieval(args.gt_data or splits_gt, pred_data, categories)
    elif args.task == "moment_retrieval":
        result = evaluate_moment_retrieval(args.gt_data or splits_gt, pred_data, categories)
    elif args.task == "moment_segmentation":
        result = compute_step_bound_scores(args.gt_data or moment_gt, pred_data, categories)
    elif args.task == "step_captioning":
        if not args.print_per_category:
            categories = Categories.single()
        from hirest_tpu_torch.eval.coco import CocoEvaluator
        result = evaluate_step_captions(
            args.gt_data or moment_gt, pred_data, categories,
            clipscore_fn=clipscore_fn, bertscore_fn=bertscore_fn,
            entailment_fn=entailment_fn,
            coco_evaluator=CocoEvaluator(
                meteor_version=args.meteor_version))
    else:
        result = {"all": {}}

    if not args.print_per_category:
        print(result["all"])
    else:
        print(result)
    return result


if __name__ == "__main__":
    main()
