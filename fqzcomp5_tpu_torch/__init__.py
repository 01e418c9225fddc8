"""PyTorch + CUDA port of the fqzcomp5_tpu wave engine (see README.md).

The host layer (``options``, ``constants``, ``container``, ``fastq``,
``fastq_fast``, ``names``, ``learning``, ``blocks``, ``drivers``,
``inspect_tool``, ``codecs/``, ``utils/``) is the port's own copy of the
JAX package's, so the port imports nothing of ``fqzcomp5_tpu``.  The
native C++ library under ``native/`` at the repository root is shared.

Importing the package does no CUDA work; the kernels are built with nvcc
at their first launch (ops/_build.py).
"""
