"""Task evaluators for the four HiREST tasks.

A copy of hirest_tpu/eval/metrics.py: the port imports nothing of the JAX
package.

Pure NumPy re-implementations with score parity against the reference
evaluator (reference evaluate.py):

- video retrieval  R@{1,5,10,50} per category        (evaluate.py:33-81)
- moment retrieval R@tIoU in {0.5, 0.7}              (evaluate.py:83-121)
- moment segmentation precision/recall @ tIoU        (evaluate.py:123-188)
- 1-D NMS + gap-filling bound preprocessing          (evaluate.py:322-412)

Step-captioning text metrics live in hirest_tpu_torch.eval.captions (pure-python
COCO-style scorers) — model-backed scorers (BERTScore, entailment,
CLIPScore) are optional plugins there.

All evaluators consume/produce the same JSON schemas as the reference
(README.md:159-242), so prediction files are interchangeable between the
two implementations.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

RECALL_KS = (1, 5, 10, 50)
TIOUS = (0.5, 0.7)


def _load(data):
    if isinstance(data, str):
        with open(data, "r") as f:
            return json.load(f)
    assert isinstance(data, dict), "data must be a path or a dict"
    return data


@dataclass
class Categories:
    """Prompt/video -> category maps (reference evaluate.py:444-461)."""

    prompt_to_cat: dict = field(default_factory=dict)
    video_to_cat: dict = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Categories":
        data = _load(path)
        return cls(prompt_to_cat=data["prompt_to_cat"], video_to_cat=data["video_to_cat"])

    @classmethod
    def single(cls) -> "Categories":
        """Degenerate map: everything scores under 'all' only."""
        return cls()

    @property
    def names(self) -> list:
        cats = set(self.prompt_to_cat.values()) | set(self.video_to_cat.values())
        return list(cats) + ["all"]

    def of_prompt(self, prompt: str) -> str:
        return self.prompt_to_cat.get(prompt, "all")

    def of_video(self, video: str) -> str:
        return self.video_to_cat.get(video, "all")


def compute_iou(interval_1, interval_2) -> float:
    """Temporal IoU with the reference's exact union formula (evaluate.py:25-31)."""
    start_i, end_i = interval_1[0], interval_1[1]
    start, end = interval_2[0], interval_2[1]
    intersection = max(0, min(end, end_i) - max(start, start_i))
    union = min(max(end, end_i) - min(start, start_i), end - start + end_i - start_i)
    return float(intersection) / (union + 1e-8)


# ---------------------------------------------------------------------------
# Task 1: video retrieval
# ---------------------------------------------------------------------------


def evaluate_video_retrieval(gt_data, pred_data, categories: Categories | None = None,
                             ks=RECALL_KS) -> dict:
    """R@k per category: a prompt counts if any of its top-k videos is a GT video.

    Score parity with reference evaluate.py:33-81 including the tie-breaking
    order of `sorted(zip(scores, videos))` followed by reversal.
    """
    gt, pred = _load(gt_data), _load(pred_data)
    categories = categories or Categories.single()

    count = {cat: {k: 0 for k in ks} for cat in categories.names}
    total = {cat: 0 for cat in categories.names}

    for prompt in gt:
        prompt_cat = categories.of_prompt(prompt)
        gt_videos = list(gt[prompt].keys())

        total["all"] += 1
        if prompt_cat != "all":
            total[prompt_cat] += 1

        videos = pred[prompt]["videos"]
        scores = pred[prompt]["scores"]
        scores, videos = zip(*sorted(zip(scores, videos)))
        videos = videos[::-1]

        for k in ks:
            if any(v in gt_videos for v in videos[:k]):
                count["all"][k] += 1
                if prompt_cat != "all":
                    count[prompt_cat][k] += 1

    results = {}
    for cat in categories.names:
        if total[cat] > 0:
            results[cat] = {"total_prompt_count": total[cat]}
            for k in ks:
                results[cat][f"R@{k}"] = (count[cat][k] / total[cat]) * 100
    return results


# ---------------------------------------------------------------------------
# Task 2: moment retrieval
# ---------------------------------------------------------------------------


def evaluate_moment_retrieval(gt_data, pred_data, categories: Categories | None = None,
                              tious=TIOUS) -> dict:
    """Accuracy at IoU >= tIoU over clippable videos (reference evaluate.py:83-121)."""
    gt, pred = _load(gt_data), _load(pred_data)
    categories = categories or Categories.single()

    score_dict = {cat: {} for cat in categories.names}
    for tiou in tious:
        scores = {cat: [] for cat in categories.names}
        for prompt in gt:
            prompt_cat = categories.of_prompt(prompt)
            for video in gt[prompt]:
                if gt[prompt][video]["clip"]:
                    iou = compute_iou(gt[prompt][video]["bounds"], pred[prompt][video]["bounds"])
                    score = 1 if iou >= tiou else 0
                    scores["all"].append(score)
                    if prompt_cat != "all":
                        scores[prompt_cat].append(score)
        for cat in categories.names:
            if scores[cat]:
                score_dict[cat]["total_videos"] = len(scores[cat])
                score_dict[cat][f"R@{tiou}"] = float(np.mean(scores[cat]) * 100)
    return score_dict


# ---------------------------------------------------------------------------
# Task 3: moment segmentation (step-bound precision/recall)
# ---------------------------------------------------------------------------


def compute_step_bound_scores(gt_data, pred_data, categories: Categories | None = None,
                              tious=TIOUS) -> dict:
    """Per-video segment precision/recall at tIoU (reference evaluate.py:123-188).

    Note the reference computes precision with the final loop index
    (`pred_i + 1`, i.e. the number of predicted segments) — preserved here.
    """
    gt, pred = _load(gt_data), _load(pred_data)
    categories = categories or Categories.single()

    results = {cat: {"recall": {}, "precision": {}} for cat in categories.names}

    for tiou in tious:
        recall = {cat: [] for cat in categories.names}
        precision = {cat: [] for cat in categories.names}

        for video in gt:
            video_cat = categories.of_video(video)
            refs = gt[video]["bounds"]
            preds = pred[video]["bounds"]

            ref_set_covered = set()
            pred_set_covered = set()
            for pred_i, pred_x in enumerate(preds):
                for ref_i, gt_x in enumerate(refs):
                    if compute_iou(pred_x, gt_x) > tiou:
                        ref_set_covered.add(ref_i)
                        pred_set_covered.add(pred_i)

            # NB: empty preds score precision 0.0. The reference divides by
            # a LEAKED loop variable (evaluate.py: pred_i survives from the
            # previous video), which gives 0.0 here too whenever it doesn't
            # NameError on a first-video-empty prediction — 0.0 is the only
            # sane reading of that behavior.
            new_precision = (float(len(pred_set_covered)) / len(preds)
                             if preds else 0.0)
            new_recall = float(len(ref_set_covered)) / len(refs)

            recall["all"].append(new_recall)
            precision["all"].append(new_precision)
            if video_cat != "all":
                recall[video_cat].append(new_recall)
                precision[video_cat].append(new_precision)

        for cat in categories.names:
            if recall[cat]:
                results[cat]["recall"][f"{tiou}"] = sum(recall[cat]) / len(recall[cat]) * 100
                results[cat]["precision"][f"{tiou}"] = sum(precision[cat]) / len(precision[cat]) * 100
                results[cat]["total"] = len(recall[cat])
    return results


# ---------------------------------------------------------------------------
# Bound preprocessing: 1-D NMS + gap filling
# ---------------------------------------------------------------------------


def nms_1d(intervals: np.ndarray, overlap_thresh: float = 0.0) -> np.ndarray:
    """Greedy interval suppression, numerically identical to the reference's
    degenerate-2D-box NMS (evaluate.py:322-356).

    The reference embeds [start, end] as boxes [x1, 0, x2, 1]; with unit
    height the overlap ratio reduces to 1-D `(w * 2) / (len_j * 2)` where
    `w = max(0, min(x2_i, x2_j) - max(x1_i, x1_j) + 1)`. Candidate order is
    argsort of the constant y2 column (stable -> original order), so the
    *last-listed* interval is picked first, as in the reference.
    """
    if len(intervals) == 0:
        return np.zeros((0, 2))
    boxes = np.asarray(intervals, dtype=float)
    x1, x2 = boxes[:, 0], boxes[:, 1]
    length = x2 - x1 + 1
    idxs = list(range(len(boxes)))  # argsort of constant y2 is stable identity
    pick = []
    while idxs:
        last = len(idxs) - 1
        i = idxs[last]
        pick.append(i)
        rest = np.array(idxs[:last], dtype=int)
        if rest.size:
            w = np.maximum(0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + 1)
            overlap = w / length[rest]
            keep = np.where(overlap <= overlap_thresh)[0]
            idxs = [idxs[j] for j in keep]
        else:
            idxs = []
    return boxes[pick]


def preprocess_moment_bounds(gt_data, pred_data) -> dict:
    """Filter out-of-moment bounds, NMS, then fill gaps so segments tile the
    GT moment (reference evaluate.py:358-412). Returns the updated pred dict.
    """
    gt, pred = _load(gt_data), _load(pred_data)

    for video in pred:
        bounds = pred[video]["bounds"]
        gt_bounds = gt[video]["bounds"]
        min_x = gt_bounds[0][0]
        max_x = gt_bounds[-1][1]

        bounds = [b for b in bounds if (b[0] > min_x and b[1] < max_x)]
        kept = nms_1d(np.array(bounds).reshape(-1, 2))

        if len(kept) > 0:
            bounds = sorted([[float(s), float(e)] for s, e in kept], key=lambda x: x[0])
            new_bounds = []
            if bounds[0][0] > min_x:
                new_bounds.append([min_x, bounds[0][0]])
            for i in range(len(bounds)):
                new_bounds.append(bounds[i])
                if i + 1 < len(bounds):
                    new_bounds.append([bounds[i][1], bounds[i + 1][0]])
            if new_bounds[-1][1] < max_x:
                new_bounds.append([new_bounds[-1][1], max_x])
        else:
            new_bounds = [[min_x, max_x]]

        pred[video]["bounds"] = new_bounds

    return pred
