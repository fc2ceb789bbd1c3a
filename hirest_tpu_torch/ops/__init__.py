"""ops of the PyTorch/CUDA port."""
