"""Shared helpers for the port's parity tests: the same NumPy arrays go
to both packages, and integer results must match bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core import interop


def to_jax(rel: tc.Relation) -> jc.Relation:
    rid, key = interop.to_numpy(rel)
    return jc.Relation(jnp.asarray(rid), jnp.asarray(key))


def to_torch(rel: jc.Relation, device="cpu") -> tc.Relation:
    return interop.from_numpy(tc.Relation, jax.tree.leaves(rel), device)


def relation(keys, rids=None) -> tuple[jc.Relation, tc.Relation]:
    """One relation from NumPy keys (rids default to arange), in both."""
    keys = np.asarray(keys, dtype=np.int32)
    rids = (np.arange(keys.shape[0], dtype=np.int32) if rids is None
            else np.asarray(rids, dtype=np.int32))
    return (jc.Relation(jnp.asarray(rids), jnp.asarray(keys)),
            interop.from_numpy(tc.Relation, [rids, keys], device="cpu"))


def flatten(obj) -> list[np.ndarray]:
    """A port object, tensor, or list/tuple of them, as NumPy leaves."""
    if isinstance(obj, (list, tuple)):
        return [a for x in obj for a in flatten(x)]
    if isinstance(obj, torch.Tensor):
        return [obj.cpu().numpy()]
    return list(interop.to_numpy(obj))


def assert_same(jax_obj, torch_obj) -> None:
    """Every leaf equal bit for bit, with equal shapes, in leaf order."""
    want = [np.asarray(x) for x in jax.tree.leaves(jax_obj)]
    got = flatten(torch_obj)
    assert len(want) == len(got), (len(want), len(got))
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape, (i, w.shape, g.shape)
        w64, g64 = w.astype(np.int64), g.astype(np.int64)
        if not np.array_equal(w64, g64):
            bad = np.flatnonzero(w64.ravel() != g64.ravel())
            raise AssertionError(
                f"leaf {i}: {bad.size} differ, first at {bad[0]}: "
                f"jax {w64.ravel()[bad[0]]} vs torch {g64.ravel()[bad[0]]}")
