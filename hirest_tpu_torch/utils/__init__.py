"""utils of the PyTorch/CUDA port."""
