"""Bring-up tools for the port's CUDA chunk kernels (counterparts of the
JAX package's ``tools/mosaic_bisect.py`` and ``tools/mosaic_eqn_bisect.py``)."""
