"""Plain PyTorch version of the hash kernel.

Counterpart of ``repro/kernels/hash/ref.py``; it lives beside its kernel
in ``hash.py``.
"""
from .hash import hash_bucket_plain as hash_bucket_ref

__all__ = ["hash_bucket_ref"]
