"""Step-captioning evaluation (reference evaluate.py:190-320).

A copy of hirest_tpu/eval/captions.py: the port imports nothing of the JAX
package.

Aligns the i-th predicted caption with the i-th GT caption of each video and
scores with:

- COCO metrics (BLEU/ROUGE-L/CIDEr): pure Python (hirest_tpu_torch.eval.coco),
  always available.
- Entailment, BERTScore, CLIPScore: model-backed, injected as optional
  scorer callables (the reference hard-depends on allennlp / bert_score /
  torch CLIP; here they are plugins so the evaluator runs anywhere).

Output dict shape matches the reference, including the "Netural" key
spelling (evaluate.py:312), so downstream score parsers see identical JSONs.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from hirest_tpu_torch.eval.coco import CocoEvaluator
from hirest_tpu_torch.eval.metrics import Categories, _load


def evaluate_step_captions(
    gt_data,
    pred_data,
    categories: Optional[Categories] = None,
    entailment_fn: Optional[Callable[[str, str], int]] = None,
    bertscore_fn: Optional[Callable[[list, list], float]] = None,
    clipscore_fn: Optional[Callable[[str, str, float, float], Optional[float]]] = None,
    coco_evaluator: Optional[CocoEvaluator] = None,
) -> dict:
    """Returns {category: {CLIPScore, BERTScore_F1, Total, Entailment, ...,
    Bleu_1..4, ROUGE_L, CIDEr}} with all scores already scaled as the
    reference prints them (COCO metrics x100)."""
    gt, pred = _load(gt_data), _load(pred_data)
    categories = categories or Categories.single()
    coco_evaluator = coco_evaluator or CocoEvaluator()

    # the reference requires predictions to cover every GT video and every
    # caption slot (evaluate.py:229-234 indexes pred[video]["captions"][i]
    # unconditionally and dies on a bare KeyError); same contract here, but
    # diagnosed up front with the offending videos named
    missing = [v for v in gt
               if v not in pred
               or len(pred[v].get("captions", [])) < len(gt[v]["captions"])]
    if missing:
        raise ValueError(
            f"predictions must cover every GT video and caption slot "
            f"(reference contract); {len(missing)}/{len(gt)} GT videos "
            f"missing or short in predictions, e.g. {missing[:5]} — score "
            f"against a GT restricted to the predicted split instead")

    if entailment_fn is None:
        # the reference ALWAYS reports this metric (evaluate.py:197-201);
        # omitting it must be loud, never silent
        import sys

        print("WARNING: Entailment/Contradiction/Netural SKIPPED - no "
              "entailment_fn. Place an HF BERT NLI checkpoint at "
              "./pretrained_weights/nli (pytorch_model.bin + config.json + "
              "vocab.txt) for the port's scorer "
              "(hirest_tpu_torch.models.nli), or inject entailment_fn.",
              file=sys.stderr)

    all_results = {}
    for cat in categories.names:
        refs: list[str] = []
        cands: list[str] = []
        total_videos = 0
        entailment_scores = [0, 0, 0]
        total_entailment_count = 0
        clip_scores: list[float] = []

        for video in gt:
            video_cat = categories.of_video(video)
            vid_clip_scores: list[float] = []
            if cat == video_cat or cat == "all":
                total_videos += 1
                for i, d in enumerate(gt[video]["captions"]):
                    gt_sent = d["sentence"].lower()
                    cand = pred[video]["captions"][i]["sentence"].lower()

                    if clipscore_fn is not None:
                        s = clipscore_fn(video, cand, d["start"], d["end"])
                        if s is not None:
                            vid_clip_scores.append(float(s))

                    refs.append(gt_sent)
                    cands.append(cand)

            clip_scores.extend(vid_clip_scores)

        # score all (gt, pred) pairs of the category at once when the
        # scorer exposes a batched surface (hirest_tpu_torch.models.nli does):
        # one padded dispatch per 256 pairs instead of one blocking
        # [1, L] device round trip per caption pair
        if entailment_fn is not None and refs:
            batched = getattr(entailment_fn, "batch", None)
            if batched is not None:
                labels = batched(list(zip(refs, cands)))
            else:
                labels = [entailment_fn(g, c) for g, c in zip(refs, cands)]
            for k in labels:
                entailment_scores[int(k)] += 1
            total_entailment_count = len(labels)

        if not refs or not cands:
            continue

        if not clip_scores:
            clip_scores = [0]

        results = {
            "CLIPScore": float(np.average(clip_scores)),
            "Total": total_videos,
        }
        if bertscore_fn is not None:
            results["BERTScore_F1"] = float(bertscore_fn(cands, refs))
        if total_entailment_count > 0:
            results["Entailment"] = (entailment_scores[0] / total_entailment_count) * 100
            results["Contradiction"] = (entailment_scores[1] / total_entailment_count) * 100
            results["Netural"] = (entailment_scores[2] / total_entailment_count) * 100

        coco_results = coco_evaluator.run_evaluation(cands, refs)
        for metric in coco_results:
            results[metric] = coco_results[metric] * 100

        all_results[cat] = results

    return all_results


def make_clipscore_fn(frame_dir: str, encode_image_fn, encode_text_fn, preprocess_fn):
    """Build the reference's CLIPScore callable (evaluate.py:236-268): mean
    cosine between the caption embedding and 4 linspace-sampled frame
    embeddings of the step. Model functions are injected (the port's CLIP towers or any
    other implementation)."""
    from glob import glob

    from hirest_tpu_torch.extraction.frames import resolve_frame_dir

    def _clipscore(video: str, caption: str, start: float, end: float):
        frames = glob(f"{resolve_frame_dir(frame_dir, video)}/*.jpg")
        frames.sort(key=lambda a: int(a.split("_")[-1].replace(".jpg", "")))
        if start >= len(frames) or end >= len(frames):
            return None
        idxes = np.linspace(start, min(end, len(frames)) - 1, 4).astype(int)
        images = np.stack([preprocess_fn(frames[i]) for i in idxes])
        image_features = np.asarray(encode_image_fn(images))
        text_features = np.asarray(encode_text_fn([caption]))
        image_features = image_features / np.linalg.norm(image_features, axis=-1, keepdims=True)
        text_features = text_features / np.linalg.norm(text_features, axis=-1, keepdims=True)
        return float(np.mean(image_features @ text_features.T))

    return _clipscore
