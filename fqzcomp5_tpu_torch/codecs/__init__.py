"""Codec layer: native (C++) host engine + numpy/JAX device engines."""
