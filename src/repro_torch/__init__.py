"""PyTorch + CUDA port of the ``repro`` hash-join reproduction.

The JAX package ``repro`` is the reference this package is held against.
This package imports ``torch`` and ``numpy``, never ``jax`` or ``repro``;
its CUDA kernels (``csrc/``) are built at first use, so it imports on a
host with no ``nvcc`` and no card.
"""
