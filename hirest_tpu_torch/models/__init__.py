"""models of the PyTorch/CUDA port."""
