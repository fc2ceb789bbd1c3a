"""Inference: beam search and iterative segmentation (infer/beam.py,
infer/segmentation.py) and zero-shot video retrieval (infer/retrieval.py)."""
