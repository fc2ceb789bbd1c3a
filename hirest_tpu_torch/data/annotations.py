"""Annotation parsing: HiREST split JSONs -> per-task example tables.

An own copy of hirest_tpu/data/annotations.py (the port imports nothing of the JAX package).

Replicates the example-construction semantics of the reference
`MomentDataset.__init__` (hirest_dataset.py:127-318) exactly — including
the teacher-forcing expansion for moment segmentation (one example per GT
boundary), the `len(all_boundaries) <= 2` skip, and the per-step expansion
for step captioning — but as plain dicts of numpy arrays with no torch and
no framework coupling.

Example schema (all tasks): fname, prompt, video_duration (rounded int),
n_frames (bin count for this sample), task + task-specific fields
documented per task below. Masks are int32 arrays of length n_frames;
batching pads them to a bucket later.
"""

from __future__ import annotations

import json
from copy import deepcopy
from typing import Optional

import numpy as np

from hirest_tpu_torch.timeline import timestamp_to_frame_index, frame_index_to_timestamp

TASKS = ("moment_retrieval", "moment_segmentation", "step_captioning")


def load_annotations(data_path: str) -> dict:
    with open(data_path, "r") as f:
        return json.load(f)


def build_examples(
    annotations: dict,
    task: str,
    n_model_frames: int = -1,
    is_train: bool = False,
    end_to_end: bool = False,
) -> list[dict]:
    """Build the example table for one task.

    `is_train` mirrors the reference's `'train' in str(data_path)` switch
    that selects the teacher-forcing expansion for segmentation.
    """
    assert task in TASKS, task
    data: list[dict] = []

    for prompt, video_anns in annotations.items():
        for video_fname, video_ann in video_anns.items():
            if not video_ann["relevant"]:
                continue
            if not video_ann["clip"]:
                continue

            video_duration = round(video_ann["v_duration"])
            n_frames = n_model_frames if n_model_frames > 0 else video_duration
            if n_frames < 1 or int(video_duration) < 1:
                # sub-second video: zero timeline bins — every frame index
                # would be invalid (timeline.timestamp_to_frame_index now
                # raises rather than returning -1); no such videos exist in
                # the shipped splits, but junk custom annotations must skip
                # cleanly instead of corrupting targets
                continue

            datum = {
                "fname": video_fname,
                "prompt": prompt,
                "video_duration": video_duration,
                "n_model_frames": n_model_frames,
                "n_frames": n_frames,
                "task": task,
            }

            def bin_of(ts):
                return timestamp_to_frame_index(ts, video_duration=video_duration,
                                                n_frames=n_frames)

            if task == "moment_retrieval":
                moment_start, moment_end = video_ann["bounds"]
                start_frame = bin_of(moment_start)
                end_frame = bin_of(moment_end)
                d = deepcopy(datum)
                d["moment_retrieval_start_target"] = start_frame
                d["moment_retrieval_end_target"] = end_frame
                d["original_bounds"] = [[moment_start, moment_end]]
                d["approximate_bounds"] = [[
                    frame_index_to_timestamp(start_frame, video_duration, n_frames),
                    frame_index_to_timestamp(end_frame, video_duration, n_frames)]]
                d["video_mask"] = np.ones(n_frames, dtype=np.int32)
                d["moment_mask"] = np.ones(n_frames, dtype=np.int32)
                data.append(d)

            elif task == "moment_segmentation":
                if not end_to_end and len(video_ann["steps"]) == 0:
                    continue

                moment_start, moment_end = video_ann["bounds"]
                moment_start_frame = bin_of(moment_start)
                moment_end_frame = bin_of(moment_end)

                all_boundaries = sorted({b for step in video_ann["steps"]
                                         for b in step["absolute_bounds"]})
                all_boundaries_frames = [bin_of(b) for b in all_boundaries]

                if is_train:
                    if len(all_boundaries) <= 2:
                        continue
                    for i in range(len(all_boundaries) - 1):
                        d = deepcopy(datum)
                        # boundaries are already converted once above —
                        # re-running bin_of here was O(B^2) linspace builds
                        step_start_frame = all_boundaries_frames[i]
                        step_end_frame = all_boundaries_frames[i + 1]

                        prev = np.zeros(n_frames, dtype=np.int32)
                        prev[all_boundaries_frames[: i + 1]] = 1
                        d["prev_boundary_mask"] = prev
                        d["moment_segmentation_target"] = step_end_frame

                        mm = np.zeros(n_frames, dtype=np.int32)
                        mm[step_start_frame: moment_end_frame + 1] = 1
                        d["moment_mask"] = mm
                        d["video_mask"] = np.ones(n_frames, dtype=np.int32)
                        d["moment_bound_timestamps"] = [moment_start, moment_end]
                        d["moment_bound_frames"] = [moment_start_frame, moment_end_frame]
                        d["all_bound_frames"] = all_boundaries_frames
                        data.append(d)
                else:
                    d = deepcopy(datum)
                    d["moment_bound_timestamps"] = [moment_start, moment_end]
                    d["moment_bound_frames"] = [moment_start_frame, moment_end_frame]
                    mm = np.zeros(n_frames, dtype=np.int32)
                    mm[moment_start_frame: moment_end_frame + 1] = 1
                    d["moment_mask"] = mm
                    d["video_mask"] = np.ones(n_frames, dtype=np.int32)
                    d["all_bound_frames"] = all_boundaries_frames
                    data.append(d)

            elif task == "step_captioning":
                if not end_to_end and len(video_ann["steps"]) == 0:
                    continue
                for step in video_ann["steps"]:
                    step_start, step_end = step["absolute_bounds"]
                    step_text = step["heading"].strip()
                    start_frame = bin_of(step_start)
                    end_frame = bin_of(step_end)

                    d = deepcopy(datum)
                    d["target_text_raw"] = step_text
                    mm = np.zeros(n_frames, dtype=np.int32)
                    mm[start_frame:end_frame] = 1
                    mm[end_frame] = 1
                    d["moment_mask"] = mm
                    d["video_mask"] = np.ones(n_frames, dtype=np.int32)
                    data.append(d)

    return data


def caption_targets(tokenizer, caption: str, max_words: int) -> dict:
    """WordPiece teacher-forcing targets, parity with
    `clip4cap_get_text` (hirest_dataset.py:533-580):
    input = [CLS] + tokens, output = tokens + [SEP], zero-padded.
    Returns int32 arrays of length max_words.
    """
    total_length_with_cls = max_words - 1
    caption_words = tokenizer.tokenize(caption)
    if len(caption_words) > total_length_with_cls:
        caption_words = caption_words[:total_length_with_cls]
    input_ids = tokenizer.convert_tokens_to_ids(["[CLS]"] + caption_words)
    output_ids = tokenizer.convert_tokens_to_ids(caption_words + ["[SEP]"])
    mask = [1] * len(input_ids)
    while len(input_ids) < max_words:
        input_ids.append(0)
        output_ids.append(0)
        mask.append(0)
    return {
        "input_caption_ids": np.array(input_ids, dtype=np.int32),
        "output_caption_ids": np.array(output_ids, dtype=np.int32),
        "decoder_mask": np.array(mask, dtype=np.int32),
    }
