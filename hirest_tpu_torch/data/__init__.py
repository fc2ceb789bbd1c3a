"""data of the PyTorch/CUDA port."""
