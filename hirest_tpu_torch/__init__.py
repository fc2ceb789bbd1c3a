"""PyTorch/CUDA port of HiREST-TPU for NVIDIA Hopper.

Mirrors the module names of the JAX package `hirest_tpu`, which stays the
reference. This package imports torch and never jax, flax or `hirest_tpu`:
what it needs from a jax-free module there, it keeps its own copy of. Entry
points run on CUDA unless the caller passes device="cpu".
"""
