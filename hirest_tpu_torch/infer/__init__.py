"""Inference: beam search and iterative segmentation (infer/beam.py,
infer/segmentation.py), zero-shot video retrieval (infer/retrieval.py) and
the end-to-end pipeline (infer/pipeline.py)."""
