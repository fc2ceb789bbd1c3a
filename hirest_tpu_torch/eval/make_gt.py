"""Build the formatted evaluation GT from a split annotation JSON.

A copy of hirest_tpu/eval/make_gt.py, with its CLI: `python -m
hirest_tpu_torch.eval.make_gt --split_json all_data_val.json --out gt.json`.

The reference ships `data/evaluation/formatted_moment_evaluation_gt.json`
pre-built for the test split only; this tool derives the same schema
({video: {captions: [{start, end, sentence}], bounds: [[s, e], ...]}})
from any `all_data_*.json`, e.g. for the val-as-test dev-eval workflow.
"""

from __future__ import annotations

import argparse
import json


def build_formatted_gt(annotations: dict) -> dict:
    out: dict = {}
    for prompt, videos in annotations.items():
        for video, ann in videos.items():
            if not (ann.get("relevant") and ann.get("clip")):
                continue
            steps = ann.get("steps") or []
            if not steps:
                continue
            out[video] = {
                "captions": [{"start": s["absolute_bounds"][0],
                              "end": s["absolute_bounds"][1],
                              "sentence": s["heading"]}  # raw, incl. spaces
                             for s in steps],
                "bounds": [list(s["absolute_bounds"]) for s in steps],
            }
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--split_json", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    with open(a.split_json) as f:
        anns = json.load(f)
    gt = build_formatted_gt(anns)
    with open(a.out, "w") as f:
        json.dump(gt, f, indent=1)
    print(f"wrote {len(gt)} videos to {a.out}")


if __name__ == "__main__":
    main()
