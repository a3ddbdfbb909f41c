"""Columnar relations and synthetic data generators.

Counterpart of ``repro/core/relation.py``.  The paper (§5.1) uses
two-column relations ``(rid, key)`` of 4-byte integers: 16M tuples by
default, uniform keys, two skewed sets (s=10% and s=25% duplicated keys)
and a selectivity knob for the probe side.  The generators draw from
``numpy.random.default_rng(seed)`` exactly as the JAX package does, so one
seed gives the same relation in both packages.

Generators place their tensors on ``device``, which defaults to ``cuda``;
with no CUDA device they raise unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.hash.ops import hash_bucket
from ..kernels.partition_hist.fused import (MURMUR_C1, MURMUR_C2,
                                            fmix32_int64)

TUPLE_BYTES = 8  # (rid, key) 4-byte ints, as in the paper.

__all__ = ["MURMUR_C1", "MURMUR_C2", "TUPLE_BYTES", "IndexChain", "Relation",
           "bucket_of", "murmur3_fmix32", "next_pow2", "probe_with_selectivity",
           "radix_of", "resolve_device", "skewed_relation", "uniform_relation",
           "unique_relation"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


@dataclasses.dataclass
class Relation:
    """A columnar relation of ``(rid, key)`` pairs.

    ``rid`` and ``key`` are int32 tensors of identical shape ``(n,)`` on
    one device.
    """

    rid: torch.Tensor
    key: torch.Tensor
    # Structural fingerprint hint, carried for the engine slice (see
    # ``repro.core.relation.Relation.fp_hint``).
    fp_hint: str | None = None

    @property
    def size(self) -> int:
        return int(self.rid.shape[0])

    @property
    def nbytes(self) -> int:
        return self.size * TUPLE_BYTES

    @property
    def device(self) -> torch.device:
        return self.key.device

    def take(self, lo: int, hi: int) -> "Relation":
        return Relation(self.rid[lo:hi], self.key[lo:hi])

    def gather(self, idx) -> "Relation":
        """Rows selected by index (the semijoin/materialization primitive).

        Out-of-range rows follow ``take_fill``: both columns read
        ``INT32_MIN`` there, as ``jnp.take`` gives."""
        idx = torch.as_tensor(idx, device=self.device)
        return Relation(take_fill(self.rid, idx), take_fill(self.key, idx))

    def to(self, device) -> "Relation":
        return Relation(self.rid.to(device), self.key.to(device),
                        self.fp_hint)


def _relation(keys: np.ndarray, device) -> Relation:
    dev = resolve_device(device)
    n = keys.shape[0]
    return Relation(torch.arange(n, dtype=torch.int32, device=dev),
                    torch.from_numpy(keys.astype(np.int32)).to(dev))


def uniform_relation(n: int, *, key_range: int | None = None, seed: int = 0,
                     device=None) -> Relation:
    """Uniform-distributed key values (paper default dataset)."""
    rng = np.random.default_rng(seed)
    key_range = key_range or n
    keys = rng.integers(0, key_range, size=n, dtype=np.int32)
    return _relation(keys, device)


def unique_relation(n: int, *, seed: int = 0, device=None) -> Relation:
    """A build relation with unique keys (primary-key side)."""
    rng = np.random.default_rng(seed)
    return _relation(rng.permutation(n).astype(np.int32), device)


def skewed_relation(n: int, *, s_percent: int, seed: int = 0,
                    device=None) -> Relation:
    """Paper §5.1: ``s%`` of tuples share one duplicate key value."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n, size=n, dtype=np.int32)
    n_dup = (n * s_percent) // 100
    dup_positions = rng.choice(n, size=n_dup, replace=False)
    hot_key = np.int32(rng.integers(0, n))
    keys[dup_positions] = hot_key
    return _relation(keys, device)


def probe_with_selectivity(build: Relation, n: int, *, selectivity: float,
                           seed: int = 0, device=None) -> Relation:
    """Probe relation where a ``selectivity`` fraction of tuples match build
    keys (paper §5.5).  Non-matching tuples draw keys from a disjoint range.
    ``device`` defaults to the build relation's device."""
    rng = np.random.default_rng(seed)
    build_keys = build.key.cpu().numpy()
    n_match = int(round(n * selectivity))
    match_keys = rng.choice(build_keys, size=n_match, replace=True)
    miss_lo = int(build_keys.max()) + 1 if build_keys.size else 1
    miss_keys = rng.integers(miss_lo, miss_lo + max(n, 2),
                             size=n - n_match, dtype=np.int64)
    keys = np.concatenate([match_keys.astype(np.int64), miss_keys])
    rng.shuffle(keys)
    return _relation(keys, build.device if device is None else device)


# ---------------------------------------------------------------------------
# Composable row-index chains (device-resident stage hand-off).
# ---------------------------------------------------------------------------

CHAIN_DEPTH_CAP = 4


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for ``dtype``: NaN for floats, the least value
    of a signed integer type, the greatest of an unsigned one (True for
    bool)."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed \
        else torch.iinfo(dtype).max


def take_fill(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col`` gathered along axis 0 with ``jnp.take``'s default "fill"
    mode: an index ``-n <= i < 0`` wraps to ``i + n``; any other index out
    of ``[0, n)`` reads the fill value (``INT32_MIN`` for int32).

    Elementwise ops and one gather on the device, no host sync.  A
    non-empty take from an empty column raises ``IndexError``, as
    ``jnp.take`` does.
    """
    n = col.shape[0]
    if n == 0:
        if idx.numel():
            raise IndexError("Cannot do a non-empty take from an empty "
                             "axis.")
        return col.new_empty(tuple(idx.shape) + tuple(col.shape[1:]))
    idx = idx.to(col.device)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = col[torch.where(ok, idx, 0)]
    ok = ok.reshape(tuple(ok.shape) + (1,) * (col.dim() - 1))
    return torch.where(ok, out, _fill_value(col.dtype))


class IndexChain:
    """A composition of row-index gathers, kept on the device.

    ``IndexChain((i0, i1, i2)).gather(col)`` computes ``col[i0[i1][i2]]``
    without materializing the intermediate gathers of ``col``.  Chains
    deeper than ``cap`` flatten eagerly; an empty chain is the identity.
    """

    __slots__ = ("links", "_flat")

    def __init__(self, links=()):
        self.links = tuple(links)
        self._flat = self.links[0] if len(self.links) == 1 else None

    @property
    def depth(self) -> int:
        return len(self.links)

    @property
    def size(self) -> int | None:
        """Rows of the chain's output space (None for the identity)."""
        return int(self.links[-1].shape[0]) if self.links else None

    def extend(self, idx, *, cap: int = CHAIN_DEPTH_CAP) -> "IndexChain":
        """The chain followed by one more gather (flattens past ``cap``)."""
        child = IndexChain(self.links + (torch.as_tensor(idx),))
        if child.depth > cap:
            return IndexChain((child.flat(),))
        return child

    def flat(self) -> torch.Tensor:
        """The chain folded to one device index vector (memoized)."""
        if self._flat is None:
            f = self.links[0]
            for link in self.links[1:]:
                f = take_fill(f, link)
            self._flat = f
        return self._flat

    def gather(self, col) -> torch.Tensor:
        """``col`` gathered through the chain: one device gather."""
        col = torch.as_tensor(col)
        if not self.links:
            return col
        return take_fill(col, self.flat())


# ---------------------------------------------------------------------------
# Hash functions.
# ---------------------------------------------------------------------------

# MurmurHash3 32-bit finalizer, as uint32 values in an int64 tensor (torch
# has no uint32 arithmetic); one definition, shared with kernel A's plain
# version.
murmur3_fmix32 = fmix32_int64


def bucket_of(key: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Step b1/p1/n1: hash bucket number (num_buckets must be 2**k).

    Kernel D (``hash_bucket``) on a CUDA tensor, its plain version on a
    CPU tensor."""
    return hash_bucket(key, num_buckets=num_buckets)


def radix_of(key: torch.Tensor, *, shift: int, bits: int) -> torch.Tensor:
    """Partition number for one radix pass: a slice of the hash's bits.

    The low slice (``shift == 0``) is a bucket number and goes through
    ``hash_bucket`` (kernel D on CUDA); a higher slice is plain torch, as
    no TPU kernel computes it."""
    if shift == 0 and bits <= 31:
        return hash_bucket(key, num_buckets=1 << bits)
    h = murmur3_fmix32(key)
    return ((h >> shift) & ((1 << bits) - 1)).to(torch.int32)


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())
