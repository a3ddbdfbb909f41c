"""Hand-written Hopper kernels and their plain PyTorch versions.

Kernel sources live in ``repro_torch/csrc`` and are built at first use
(``_build.py``), never at import.
"""
from .agg import agg as _agg
from .csr_probe import csr_probe as _csr
from .flash_attn import flash_attn as _flash
from .hash import hash as _hash
from .partition_hist import (fused as _fused, partition_hist as _hist,
                             reorder as _reorder)
from .probe import probe as _probe
from .sha1_tree import sha1_tree as _sha1
from .ssd import ssd as _ssd

_COUNTED = {"partition_hist_fused": _fused, "radix_scatter": _reorder,
            "seg_agg": _agg, "hash_bucket": _hash, "radix_hist": _hist,
            "partitioned_probe": _probe, "flash_attn": _flash,
            "ssd_intra_chunk": _ssd, "csr_probe": _csr,
            "sha1_tree": _sha1}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
        for variant in getattr(mod, "launches_by_variant", {}):
            mod.launches_by_variant[variant] = 0
