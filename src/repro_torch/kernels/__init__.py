"""Hand-written Hopper kernels and their plain PyTorch versions.

Kernel sources live in ``repro_torch/csrc`` and are built at first use
(``_build.py``), never at import.
"""
from ._build import launch_counts, reset_launch_counts  # noqa: F401
