"""CSR probe kernels of the hash join's probe: ``csr_probe`` (the
wrappers and their plain versions) and ``ref`` (the edge cases they are
held to, and a skewed join).  Port-only: the JAX package's probe is plain
``jnp``.  The package attribute ``csr_probe`` is the module."""
from . import csr_probe, ref  # noqa: F401
from .csr_probe import (EXPAND_COUNTERS, HEAVY, SPLIT,  # noqa: F401
                        csr_expand, csr_lookup, csr_probe_join)
