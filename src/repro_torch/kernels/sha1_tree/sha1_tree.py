"""Tree SHA-1 of a relation's columns: the content key of a relation on
the card, computed there, with only the top digests pulled.

The tree (``csrc/sha1_tree.cu`` states it in full): a column's bytes, in
leaves of ``LEAF_BYTES`` (the last may be shorter, an empty column has one
empty leaf), each leaf's digest the standard SHA-1 of its bytes; then
levels of nodes, each the SHA-1 of up to ``FANOUT`` child digests followed
by ``NODE_TAG``, until at most ``TOP_DIGESTS`` remain.  Those are the
column's top digests.  The digest depends only on the column's bytes: not
on the grid, the device or where the view starts.

On CUDA tensors ``tree_tops`` launches ``csrc/sha1_tree.cu`` (one launch a
level, both columns together); on CPU tensors it runs ``tree_tops_plain``,
the same tree in ``hashlib``.  There is no fallback between the two.
Port-only: the JAX package hashes a relation's bytes flat, on the host.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from .._build import I32, I64, PTR, kernel, launch

LEAF_BYTES = 1024
FANOUT = 64
TOP_DIGESTS = 64
NODE_TAG = b"\x01"
DIGEST_BYTES = 20
MAX_COLS = 2                 # columns in one launch

# Integer operations of one 64-byte SHA-1 block (the kernel's bound, see
# csrc/sha1_tree.cu): 80 rounds of 5, 64 schedule words of 3, 16 byte
# swaps and the 5 final adds.
OPS_PER_BLOCK = 80 * 5 + 64 * 3 + 16 + 5


def level_sizes(nbytes: int) -> list[int]:
    """Digests at each level of a column of ``nbytes`` bytes, the leaves
    first and the top digests last."""
    n = max(1, -(-int(nbytes) // LEAF_BYTES))
    sizes = [n]
    while n > TOP_DIGESTS:
        n = -(-n // FANOUT)
        sizes.append(n)
    return sizes


def top_nbytes(nbytes: int) -> int:
    """Bytes of a column's top digests: what the host pulls for it."""
    return level_sizes(nbytes)[-1] * DIGEST_BYTES


def tree_ops(nbytes: int) -> int:
    """Integer operations of a column's tree: every SHA-1 block of its
    leaves and nodes (a message of m bytes pads to (m + 9) / 64 blocks,
    rounded up) times ``OPS_PER_BLOCK``."""
    sizes = level_sizes(nbytes)
    full, last = divmod(int(nbytes), LEAF_BYTES)
    blocks = full * ((LEAF_BYTES + 8) // 64 + 1)
    if last or not full:
        blocks += (last + 8) // 64 + 1
    for below in sizes[:-1]:
        kids, rest = divmod(below, FANOUT)
        blocks += kids * ((DIGEST_BYTES * FANOUT + 9) // 64 + 1)
        if rest:
            blocks += (DIGEST_BYTES * rest + 9) // 64 + 1
    return blocks * OPS_PER_BLOCK


def _column_bytes(col: torch.Tensor) -> bytes:
    col = col.contiguous()
    return col.view(torch.uint8).numpy().tobytes() if col.numel() else b""


def tree_tops_plain(cols) -> torch.Tensor:
    """Plain version: each column's tree in ``hashlib``, its top digests
    concatenated in column order, as a CPU uint8 tensor."""
    out = []
    for col in cols:
        _check_col(col)
        data = _column_bytes(col.cpu())
        level = [hashlib.sha1(data[i:i + LEAF_BYTES]).digest()
                 for i in range(0, max(len(data), 1), LEAF_BYTES)]
        while len(level) > TOP_DIGESTS:
            level = [hashlib.sha1(b"".join(level[j:j + FANOUT])
                                  + NODE_TAG).digest()
                     for j in range(0, len(level), FANOUT)]
        out += level
    return torch.from_numpy(np.frombuffer(b"".join(out), dtype=np.uint8)
                            .copy())


def _check_col(col: torch.Tensor) -> None:
    if col.dim() != 1:
        raise ValueError(f"a column must be 1-D, got shape "
                         f"{tuple(col.shape)}")
    if col.element_size() * col.shape[0] % 4:
        raise ValueError(f"a column's bytes must be whole 4-byte words: "
                         f"{col.dtype} x {col.shape[0]}")


def _launch(name: str, dev: torch.device, jobs) -> None:
    """One launch of ``name`` over up to two ``(in_ptr, n, out_ptr)``
    jobs."""
    args = [a for job in jobs for a in job] + [0, 0, 0] * (MAX_COLS
                                                          - len(jobs))
    launch(kernel("sha1_tree", name, *[PTR, I64, PTR] * MAX_COLS, I32, PTR),
           dev, *args, len(jobs))


def tree_tops(cols) -> torch.Tensor:
    """Each column's top digests, concatenated in column order, 20 bytes
    a digest: a uint8 tensor on the columns' device.

    cols: one or two 1-D contiguous tensors on one device whose bytes are
    whole 4-byte words.  On a CUDA device the tree is built on the card
    (one launch for the leaves, one for each node level); nothing
    synchronizes.
    """
    if isinstance(cols, torch.Tensor):
        raise TypeError("cols is a sequence of columns, not one tensor")
    cols = list(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"1 to {MAX_COLS} columns, got {len(cols)}")
    dev = cols[0].device
    if dev.type == "cpu":
        return tree_tops_plain(cols)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for col in cols:
        if col.device != dev:
            raise ValueError(f"a column on {col.device}, the first on {dev}")
        _check_col(col)
        if not col.is_contiguous():
            raise ValueError("a column must be contiguous")
    sizes = [level_sizes(c.nbytes) for c in cols]
    top_bytes = sum(s[-1] for s in sizes) * DIGEST_BYTES
    # One buffer: every column's top digests first, in column order, then
    # each column's lower levels; ``levels`` holds their addresses.
    buf = torch.empty(top_bytes + sum(sum(s[:-1]) for s in sizes)
                      * DIGEST_BYTES, dtype=torch.uint8, device=dev)
    base, top_at, low_at, levels = buf.data_ptr(), 0, top_bytes, []
    for s in sizes:
        lv = []
        for k in s[:-1]:
            lv.append(base + low_at)
            low_at += k * DIGEST_BYTES
        levels.append(lv + [base + top_at])
        top_at += s[-1] * DIGEST_BYTES
    _launch("sha1_tree_leaves", dev, [(c.data_ptr(), c.nbytes, lv[0])
                                      for c, lv in zip(cols, levels)])
    for depth in range(1, max(len(s) for s in sizes)):
        _launch("sha1_tree_nodes", dev,
                [(lv[depth - 1], s[depth - 1], lv[depth])
                 for s, lv in zip(sizes, levels) if len(s) > depth])
    return buf[:top_bytes]
