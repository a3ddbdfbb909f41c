"""Partitioned probe kernel (F): ``probe`` (the kernel's wrapper),
``ref`` (its oracle) and ``ops`` (the dispatcher and the layout packing),
as in ``repro/kernels/probe``.  The function ``probe`` is
``ops.probe``; the package attribute ``probe`` stays the module."""
from . import ops, probe, ref  # noqa: F401
from .ops import build_partitioned_table  # noqa: F401
from .probe import PAD_KEY, probe_plain  # noqa: F401
from .ref import probe_ref  # noqa: F401
