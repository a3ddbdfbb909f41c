"""Checkpoints with atomic commit, a LATEST pointer and a SIGTERM flush.

Counterpart of ``repro/checkpoint/store.py``, with the same layout on
disk (one directory per step), so each package reads the other's:

    <dir>/step_000123.tmp/            # written first
        meta.json                     # leaf shapes and dtypes
        shard_<host>.npz              # the leaves, keys joined by "__"
    <dir>/step_000123/                # atomic rename on success
    <dir>/LATEST                      # pointer file, written last

A tree is nested dicts and lists of tensors (or NumPy arrays, or
numbers): the port's ``param_tree``, the AdamW state, any plain tree.
A leaf's key is its path in the JAX pytree order, dict keys and list
indices joined by "/" (then "__" in the archive).  bfloat16 leaves are
stored as float32 (exact) and restored to the dtype of the tree they
are restored into; a tensor leaf of that tree is filled in place, so
restoring into ``param_tree(lm)`` loads the LM itself.  The port's ``unit`` is a list of units, so its
model keys carry the unit's index where the JAX package's stacked
``unit`` has a leading axis; ``core.interop`` converts between the two.

A crash mid-write leaves only a ``.tmp`` directory, which restore
ignores; ``latest_step`` scans for committed steps when ``LATEST`` is
lost.  ``CheckpointManager`` installs a SIGTERM hook so a preemption
flushes a final checkpoint, and prunes old steps.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal

import numpy as np
import torch

from ..core.relation import resolve_device
from ..core.tree import flatten_with_paths, tree_map_with_path
from ..distributed.sharding import Sharding, is_dtensor
from ..models.params import distribute

_NP_DTYPES = {torch.float32: "float32", torch.float16: "float16",
              torch.float64: "float64", torch.bfloat16: "bfloat16",
              torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
              torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _NP_DTYPES.items()}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, logical dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        name = _NP_DTYPES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if not (np.issubdtype(arr.dtype, np.floating)
            or np.issubdtype(arr.dtype, np.integer)
            or arr.dtype == np.bool_):
        arr = arr.astype(np.float32)   # ml_dtypes (bfloat16) leaves
    return arr, name


def _dtype_of(leaf) -> torch.dtype:
    return _TORCH_DTYPES[str(np.asarray(leaf).dtype)]


def save_checkpoint(directory: str, step: int, tree, *,
                    host_index: int = 0) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    meta = {"step": step, "leaves": {}}
    for key, leaf in flatten_with_paths(tree).items():
        arr, dtype = _to_numpy(leaf)
        meta["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
        arrays[key.replace("/", "__")] = arr
    np.savez(os.path.join(tmp, f"shard_{host_index}.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> int | None:
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            m = re.match(r"step_(\d+)", f.read().strip())
            if m and os.path.isdir(os.path.join(directory, m.group(0))):
                return int(m.group(1))
    # Fallback: scan for committed dirs (LATEST lost).
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))] \
        if os.path.isdir(directory) else []
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like_tree, *,
                       shardings_tree=None, device=None,
                       host_index: int = 0):
    """``like_tree`` holding step ``step``'s leaves.  A tensor leaf is
    filled in place (so restoring into ``param_tree(lm)`` loads the LM,
    with no second copy of its weights; a DTensor leaf's shard from the
    full stored leaf); any other leaf becomes a new tensor of its dtype on
    ``device`` (the card unless told otherwise).

    ``shardings_tree`` (the shape of ``like_tree``, a ``Sharding`` or None
    per leaf) restores elastically: the archive keeps full leaves, so
    each is distributed onto its sharding, whatever mesh saved it; a
    DTensor leaf already on that sharding is filled in place, any other
    leaf is replaced."""
    path = os.path.join(directory, f"step_{step:08d}")
    data = np.load(os.path.join(path, f"shard_{host_index}.npz"))
    flat_sh = ({k: v for k, v in flatten_with_paths(shardings_tree).items()
                if v is not None} if shardings_tree is not None else {})

    def load(key, leaf):
        arr = torch.from_numpy(np.array(data[key.replace("/", "__")]))
        if not isinstance(leaf, torch.Tensor):
            arr = arr.to(dtype=_dtype_of(leaf))
            if key in flat_sh:
                return distribute(arr, flat_sh[key])
            return arr.to(resolve_device(device))
        if arr.shape != leaf.shape:
            raise ValueError(f"{key}: stored shape {tuple(arr.shape)}, "
                             f"tree's {tuple(leaf.shape)}")
        arr = arr.to(dtype=leaf.dtype)
        sh = flat_sh.get(key)
        if sh is None and is_dtensor(leaf):
            sh = Sharding(leaf.device_mesh, tuple(leaf.placements))
        if sh is None:
            with torch.no_grad():
                return leaf.copy_(arr)
        new = distribute(arr, sh)
        if is_dtensor(leaf) and (leaf.device_mesh, tuple(
                leaf.placements)) == tuple(sh):
            with torch.no_grad():
                leaf.to_local().copy_(new.to_local())
            return leaf
        return new

    return tree_map_with_path(load, like_tree)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    save_every: int = 50

    def __post_init__(self):
        self._preempted = False
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            pass  # not on main thread

    def _on_sigterm(self, *_):
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.save_every == 0 or self._preempted:
            save_checkpoint(self.directory, step, tree)
            self._prune()
            return True
        return False

    def _prune(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like_tree, *, shardings_tree=None,
                       device=None):
        step = latest_step(self.directory)
        if step is None:
            return None, 0
        return restore_checkpoint(self.directory, step, like_tree,
                                  shardings_tree=shardings_tree,
                                  device=device), step
