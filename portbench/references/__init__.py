"""Plain references: each a straightforward implementation, in PyTorch or
NumPy, of what a configuration computes. They import nothing of the
program and take nothing the program made; a system's check (systems/)
runs its configuration's reference on the same inputs and judges the
program's answers by it. A new model's reference is a new module here.
"""
