"""The CSR probe: steps p2 + p3 (lookup) and p4 (expand) of the hash
join's probe over the CSR hash table of ``repro_torch.core.hash_table``,
as the PHJ join phase (``partitioned_join``), ``probe_hash_table`` and
the variant probes (the lookup) run it.

On CUDA tensors ``csr_lookup`` and ``csr_expand`` launch
``csrc/csr_probe.cu``; on CPU tensors they run ``probe_p2`` -> ``probe_p3``
and ``probe_p4``, unchanged, which are their plain versions.  There is no
fallback between the two.  ``csr_probe_join`` is the whole probe: lookup,
the inclusive scan of the match counts (``torch.cumsum``, as ``probe_p4``
takes it), expand.  Every array equals the plain steps' bit for bit on a
table that ``table_from_buckets`` built.

On the card the expand picks, for each probe tuple, one of three paths
by its match count: a rid list of at most ``HEAVY`` rids is written by
its own thread, one of ``HEAVY`` + 1 to ``SPLIT`` by its warp, and a
longer one (a hot key of a skewed build) is queued by the first kernel
and split across the blocks of a second, launched right after it, so no
one warp writes a hot key's whole list.  An expand is two launches; the
queue (``max_out // SPLIT + 1`` probe indices and its length) is scratch
of the call.

``csr_expand`` also counts, where given a ``counters`` tensor, what it
expanded (``EXPAND_COUNTERS``): the pairs its probes match, those of rid
lists longer than ``HEAVY``, the longest list one probe tuple matched,
and the pairs of lists longer than ``SPLIT`` (those the second grid
writes).  The kernel counts from the match counts it loads anyway; the
CPU computes the same numbers from ``nmatch``.
"""
from __future__ import annotations

import torch

from .._build import I64, PTR, kernel, launch

INT32_MAX = 2**31 - 1
HEAVY = 8            # csrc/csr_probe.cu: longer rid lists are warp-written
SPLIT = 2048         # csrc/csr_probe.cu: longer ones are split across blocks
EXPAND_COUNTERS = ("pairs", "heavy_pairs", "warp_max_pairs", "split_pairs")


def csr_lookup_plain(table, bkt: torch.Tensor, key: torch.Tensor):
    """Plain version: ``probe_p2`` then ``probe_p3``."""
    # Imported here: repro_torch.core imports the kernels package.
    from repro_torch.core import hash_table as ht

    kstart, kcount = ht.probe_p2(table, bkt)
    return ht.probe_p3(table, key, kstart, kcount)


def csr_expand_plain(table, probe_rid: torch.Tensor, entry: torch.Tensor,
                     nmatch: torch.Tensor, max_out: int):
    """Plain version: ``probe_p4``."""
    from repro_torch.core import hash_table as ht

    return ht.probe_p4(table, probe_rid, entry, nmatch, max_out)


def _check(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, the probe on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")


def csr_lookup(table, bkt: torch.Tensor, key: torch.Tensor):
    """For each probe tuple, its key's entry in bucket ``bkt``'s key list
    (or -1) and the entry's rid count (or 0): ``probe_p3``'s ``(entry,
    nmatch)``.  bkt, key: (n,) int32.  Returns two (n,) int32 tensors."""
    dev = key.device
    if dev.type == "cpu":
        return csr_lookup_plain(table, bkt, key)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(dev, bkt=bkt, key=key, bucket_key_start=table.bucket_key_start,
           bucket_key_count=table.bucket_key_count, ukeys=table.ukeys,
           key_rid_count=table.key_rid_count)
    n = key.shape[0]
    if bkt.shape[0] != n:
        raise ValueError(f"bkt has {bkt.shape[0]} ids, key {n}")
    entry = torch.empty(n, dtype=torch.int32, device=dev)
    nmatch = torch.empty(n, dtype=torch.int32, device=dev)
    launch(kernel("csr_probe", "csr_lookup", *[PTR] * 8, I64, I64, I64, PTR),
           dev, bkt.data_ptr(), key.data_ptr(),
           table.bucket_key_start.data_ptr(),
           table.bucket_key_count.data_ptr(), table.ukeys.data_ptr(),
           table.key_rid_count.data_ptr(), entry.data_ptr(),
           nmatch.data_ptr(), n, table.num_buckets, table.ukeys.shape[0])
    return entry, nmatch


def count_expand_plain(nmatch: torch.Tensor, counters: torch.Tensor
                       ) -> None:
    """Add ``EXPAND_COUNTERS`` of the match counts ``nmatch`` to
    ``counters``: the pairs, those of lists longer than ``HEAVY``, the
    longest list (a maximum, not a sum), and the pairs of lists longer
    than ``SPLIT``."""
    m = nmatch.to(torch.int64)
    counters[0] += m.sum()
    counters[1] += m[m > HEAVY].sum()
    if m.numel():
        counters[2] = torch.maximum(counters[2], m.max())
    counters[3] += m[m > SPLIT].sum()


def _check_counters(dev: torch.device, counters) -> None:
    if counters is None:
        return
    if (counters.device != dev or counters.dtype != torch.int64
            or counters.shape != (len(EXPAND_COUNTERS),)
            or not counters.is_contiguous()):
        raise ValueError(f"counters must be a contiguous "
                         f"({len(EXPAND_COUNTERS)},) int64 tensor "
                         f"on {dev}, got {tuple(counters.shape)} "
                         f"{counters.dtype} on {counters.device}")


def csr_expand(table, probe_rid: torch.Tensor, entry: torch.Tensor,
               nmatch: torch.Tensor, max_out: int, counters=None):
    """The matching ``(probe_rid, build_rid)`` pairs in probe order, then
    rid-list order, truncated at ``max_out`` slots and padded with -1:
    ``probe_p4``'s ``JoinResult``.  probe_rid, entry, nmatch: (n,) int32,
    ``(entry, nmatch)`` as ``csr_lookup`` gives them.  ``counters``, a
    (4,) int64 tensor on the probe's device, gets ``EXPAND_COUNTERS``
    added (``warp_max_pairs`` raised to its maximum), on the device's
    stream."""
    from repro_torch.core.hash_table import JoinResult

    dev = probe_rid.device
    _check_counters(dev, counters)
    if dev.type == "cpu":
        if counters is not None:
            count_expand_plain(nmatch, counters)
        return csr_expand_plain(table, probe_rid, entry, nmatch, max_out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(dev, probe_rid=probe_rid, entry=entry, nmatch=nmatch,
           key_rid_start=table.key_rid_start, rids=table.rids)
    n = probe_rid.shape[0]
    if entry.shape[0] != n or nmatch.shape[0] != n:
        raise ValueError(f"entry {entry.shape[0]} and nmatch "
                         f"{nmatch.shape[0]} for {n} probe tuples")
    if not 0 <= max_out <= INT32_MAX:
        raise ValueError(f"max_out must lie in [0, 2^31): {max_out}")
    offs = torch.cumsum(nmatch, 0, dtype=torch.int32)
    out_probe = torch.empty(max_out, dtype=torch.int32, device=dev)
    out_build = torch.empty(max_out, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    qcap = max_out // SPLIT + 1
    queue = torch.empty(1 + qcap, dtype=torch.int64, device=dev)
    args = (probe_rid.data_ptr(), entry.data_ptr(), nmatch.data_ptr(),
            offs.data_ptr(), table.key_rid_start.data_ptr(),
            table.rids.data_ptr(), out_probe.data_ptr(), out_build.data_ptr())
    launch(kernel("csr_probe", "csr_expand", *[PTR] * 11, I64, I64, I64,
                  I64, PTR),
           dev, *args, count.data_ptr(),
           None if counters is None else counters.data_ptr(),
           queue.data_ptr(), qcap, n, table.capacity, max_out)
    launch(kernel("csr_probe", "csr_expand_split", *[PTR] * 9, I64, I64,
                  I64, PTR),
           dev, *args, queue.data_ptr(), qcap, table.capacity, max_out)
    return JoinResult(out_probe, out_build, count)


def probe_bytes(n: int, num_buckets: int, capacity: int,
                max_out: int) -> dict[str, int]:
    """Bytes each step of ``csr_probe_join`` moves for ``n`` probe tuples
    against a table of ``num_buckets`` buckets and ``capacity`` tuples:
    the lookup reads the bucket ids, keys, headers and (at most) every key
    and rid count and writes entry and nmatch; the scan reads nmatch and
    writes the offsets; the expand reads the probe rids, entries, counts
    and offsets, the rid starts and lists, and writes both slot arrays."""
    return {"lookup": 8 * n + 8 * num_buckets + 8 * capacity + 8 * n,
            "scan": 8 * n,
            "expand": 16 * n + 8 * capacity + 8 * max_out}


def csr_probe_join(table, bkt: torch.Tensor, key: torch.Tensor,
                   rid: torch.Tensor, max_out: int):
    """The whole probe of the tuples ``(rid, key)`` with bucket ids
    ``bkt`` against ``table``: p2 -> p3 -> p4 as one lookup and one
    expand (three launches on a CUDA device)."""
    entry, nmatch = csr_lookup(table, bkt, key)
    return csr_expand(table, rid, entry, nmatch, max_out)
