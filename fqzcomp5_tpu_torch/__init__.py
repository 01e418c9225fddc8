"""PyTorch + CUDA port of the fqzcomp5_tpu wave engine (see README.md).

Importing the package does no CUDA work; the kernels are built with nvcc
at their first launch (ops/_build.py).
"""
