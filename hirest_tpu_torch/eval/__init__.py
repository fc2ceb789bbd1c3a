"""Evaluation of the four HiREST tasks (counterpart of hirest_tpu/eval/)."""

from hirest_tpu_torch.eval.metrics import (  # noqa: F401
    Categories,
    compute_iou,
    compute_step_bound_scores,
    evaluate_moment_retrieval,
    evaluate_video_retrieval,
    nms_1d,
    preprocess_moment_bounds,
)
