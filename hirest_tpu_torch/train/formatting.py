"""Prediction-result formatting into the evaluate.py JSON schemas.

An own copy of hirest_tpu/train/formatting.py, on the port's timeline.py.

Parity with reference run.py:704-838: frame indices are converted back to
(truncated) second timestamps with the same binning used to build targets,
and grouped into the per-task schemas documented in the reference README
(README.md:159-242).
"""

from __future__ import annotations

import numpy as np

from hirest_tpu_torch.timeline import frame_index_to_timestamp


def format_moment_retrieval(prompts, video_fnames, video_durations, predictions,
                            n_model_frames: int, targets=None, loss=None) -> dict:
    out: dict = {}
    for i in range(len(video_fnames)):
        prompt, fname = prompts[i], video_fnames[i]
        out.setdefault(prompt, {}).setdefault(fname, {})
        start_f, end_f = int(predictions[i][0]), int(predictions[i][1])
        start = frame_index_to_timestamp(start_f, video_durations[i], n_model_frames)
        end = frame_index_to_timestamp(end_f, video_durations[i], n_model_frames)
        out[prompt][fname]["bounds"] = [start, end]
        out[prompt][fname]["video_duration"] = video_durations[i]
        if targets is not None:
            out[prompt][fname]["target_bounds"] = [int(x) for x in targets[i]]
    if loss is not None:
        out["loss"] = float(loss)
    return out


def format_moment_segmentation(video_fnames, video_durations, predictions,
                               n_model_frames: int, targets=None, loss=None) -> dict:
    out: dict = {}
    for i in range(len(video_fnames)):
        fname = video_fnames[i]
        out.setdefault(fname, {})
        raw = predictions[i]
        bounds = []
        for j in range(len(raw) - 1):
            bound = []
            try:
                bound.append(frame_index_to_timestamp(raw[j], video_durations[i], n_model_frames))
                bound.append(frame_index_to_timestamp(raw[j + 1], video_durations[i], n_model_frames))
            except Exception:
                print(f"Video: {fname} | Bound {raw[j]} or {raw[j+1]} "
                      f"out of {video_durations[i]}")
            bounds.append(bound)
        out[fname]["bounds"] = bounds
        out[fname]["video_duration"] = video_durations[i]
        out[fname]["pred_bounds"] = [int(x) for x in raw]
        if targets is not None:
            out[fname]["target_bounds"] = [int(x) for x in targets[i]]
    if loss is not None:
        out["loss"] = float(loss)
    return out


def format_step_captioning(video_fnames, video_durations, predictions,
                           targets=None, loss=None) -> dict:
    out: dict = {}
    for i in range(len(video_fnames)):
        fname = video_fnames[i]
        entry = out.setdefault(fname, {})
        entry.setdefault("captions", []).append({"sentence": predictions[i]})
        entry["video_duration"] = video_durations[i]
        if targets is not None:
            entry.setdefault("target_captions", []).append(targets[i])
    if loss is not None:
        out["loss"] = float(loss)
    return out
