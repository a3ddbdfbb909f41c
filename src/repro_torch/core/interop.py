"""State carried between the JAX package and the port, as NumPy arrays.

``to_numpy`` flattens a ``Relation``, ``HashTable``, ``JoinResult`` or
``Partitions`` into its arrays in field order, which is the order of the
JAX package's pytree leaves (``jax.tree.leaves``) for the same class.
``from_numpy`` builds the port's object back from such arrays.  Only
NumPy crosses, so this module never imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hash_table import HashTable, JoinResult
from .partition import Partitions
from .relation import Relation

_LEAVES = {Relation: 2, HashTable: 8, JoinResult: 3, Partitions: 4}


def to_numpy(obj) -> tuple[np.ndarray, ...]:
    """The object's arrays, in the JAX package's pytree-leaf order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v.detach().cpu().numpy())
        elif dataclasses.is_dataclass(v):
            out.extend(to_numpy(v))
    return tuple(out)


def from_numpy(cls, arrays, device="cpu"):
    """A ``cls`` (one of Relation, HashTable, JoinResult, Partitions) from
    arrays in the order ``to_numpy`` gives (the JAX pytree-leaf order)."""
    arrays = [np.asarray(a) for a in arrays]
    if len(arrays) != _LEAVES[cls]:
        raise ValueError(f"{cls.__name__} takes {_LEAVES[cls]} arrays, got "
                         f"{len(arrays)}")
    ts = [torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
          for a in arrays]
    if cls is Partitions:
        return Partitions(Relation(ts[0], ts[1]), ts[2], ts[3])
    return cls(*ts)
