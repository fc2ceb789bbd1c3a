"""End-to-end hierarchical inference pipeline.

Counterpart of hirest_tpu/infer/pipeline.py, on the port's annotations,
TaskBatcher and Trainer.

Chains moment retrieval -> moment segmentation -> step captioning over the
test split, producing `final_end_to_end_results.json` with the same schema
as the reference (run.py:383-490). Where the reference mutates
`all_data_test.json` on disk between stages (backing it up and restoring
it), this pipeline rewrites the annotations **in memory** and rebuilds the
stage loaders from the mutated dict — same dataflow, no temp-file dance —
while still dumping the same per-stage JSONs into ckpt_dir.
"""

from __future__ import annotations

import json
import os

from hirest_tpu_torch.data.annotations import (build_examples,
                                               caption_targets,
                                               load_annotations)
from hirest_tpu_torch.data.batching import TaskBatcher


def _stage_batcher(trainer, anns: dict, task: str):
    cfg = trainer.config
    ex = build_examples(anns, task, cfg.n_model_frames, is_train=False,
                        end_to_end=True)
    if task == "step_captioning" and trainer.tokenizer is not None:
        for e in ex:
            e.update(caption_targets(trainer.tokenizer, e["target_text_raw"],
                                     cfg.max_words))
    # under a mesh, batches padded to the batch size as the trainer's own
    # (each rank takes its rows of them)
    return TaskBatcher(ex, batch_size=cfg.eval_batch_size, store=trainer.store,
                       buckets=trainer.buckets,
                       pad_batch=trainer.mesh is not None)


def run_end_to_end(trainer, test_path: str | None = None) -> dict:
    """Run the staged pipeline over `test_path` (the config's test split by
    default); returns the final results dict."""
    cfg = trainer.config
    tasks = cfg.tasks
    if not tasks:
        # the reference gates each stage on its --task_* flag too
        # (run.py:388,429,466) and would equally echo the GT back; but a
        # "final results" file that is a verbatim GT copy is a silent
        # footgun, so say it loudly
        import sys

        print("WARNING: --end_to_end with no --task_* flags runs ZERO "
              "pipeline stages; final_end_to_end_results.json will be a "
              "verbatim copy of the test annotations. Pass "
              "--task_moment_retrieval --task_moment_segmentation "
              "--task_step_captioning.", file=sys.stderr)
    test_path = test_path or os.path.join(cfg.data_dir, "all_data_test.json")
    test = load_annotations(test_path)
    os.makedirs(cfg.ckpt_dir, exist_ok=True)

    def dump(name, obj):
        if not trainer.is_main:  # rank 0 writes under a mesh
            return
        path = os.path.join(cfg.ckpt_dir, name)
        with open(path, "w") as f:
            json.dump(obj, f, indent=4)
        if trainer.verbose:
            print("Saved", path)

    # Stage 1: moment retrieval -> overwrite bounds, seed 5 dummy steps
    # (run.py:388-419)
    if "moment_retrieval" in tasks:
        moments = trainer.evaluate(_stage_batcher(trainer, test, "moment_retrieval"),
                                   "moment_retrieval", has_target=False)
        dump("test_moment_retrieval_end_to_end.json", moments)
        for prompt in test:
            if prompt not in moments:
                continue
            for video in test[prompt]:
                if video not in moments[prompt]:
                    continue
                test[prompt][video]["bounds"] = moments[prompt][video]["bounds"]
                test[prompt][video]["steps"] = [
                    {"index": i, "heading": "", "absolute_bounds": [i, i + 1]}
                    for i in range(5)]

    # Stage 2: moment segmentation -> overwrite steps with predicted bounds
    # (run.py:429-456)
    if "moment_segmentation" in tasks:
        moments = trainer.evaluate(_stage_batcher(trainer, test, "moment_segmentation"),
                                   "moment_segmentation", has_target=False)
        dump("test_moment_segmentation_end_to_end.json", moments)
        for prompt in test:
            for video in test[prompt]:
                test[prompt][video]["steps"] = []
                if video not in moments:
                    continue
                for i, bound in enumerate(moments[video]["bounds"]):
                    test[prompt][video]["steps"].append(
                        {"index": i, "heading": "", "absolute_bounds": bound})

    # Stage 3: step captioning -> fill the headings (run.py:466-485)
    if "step_captioning" in tasks:
        moments = trainer.evaluate(_stage_batcher(trainer, test, "step_captioning"),
                                   "step_captioning", has_target=False)
        dump("test_step_captioning_end_to_end.json", moments)
        for prompt in test:
            for video in test[prompt]:
                if video in moments:
                    for i, sent in enumerate(moments[video]["captions"]):
                        if i < len(test[prompt][video]["steps"]):
                            test[prompt][video]["steps"][i]["heading"] = sent["sentence"]

    dump("final_end_to_end_results.json", test)
    return test
