"""extraction of the PyTorch/CUDA port."""
