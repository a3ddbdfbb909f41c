"""Dispatcher for the hash kernel.

``hash_bucket`` is the data path behind ``bucket_of`` and
``radix_of(shift=0)`` (``repro_torch.core.relation`` routes through it):
kernel D on a CUDA tensor at every size, its plain version on a CPU
tensor.
"""
from .hash import hash_bucket

__all__ = ["hash_bucket"]
