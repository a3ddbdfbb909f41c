"""Hand-written Hopper kernels and their plain PyTorch versions.

Kernel sources live in ``repro_torch/csrc`` and are built at first use
(``_build.py``), never at import.
"""
from .partition_hist import fused as _fused, reorder as _reorder

_COUNTED = {"partition_hist_fused": _fused, "radix_scatter": _reorder}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
