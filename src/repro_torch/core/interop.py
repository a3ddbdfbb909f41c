"""State carried between the JAX package and the port, as NumPy arrays.

``to_numpy`` flattens a ``Relation``, ``HashTable``, ``JoinResult`` or
``Partitions`` into its arrays in field order, which is the order of the
JAX package's pytree leaves (``jax.tree.leaves``) for the same class.
``from_numpy`` builds the port's object back from such arrays.

The LM's weights and serving caches cross as the JAX package's trees of
NumPy arrays (``unit`` stacked along its leading axis):
``lm_params_from_numpy`` and ``lm_cache_from_numpy`` fill the port's
modules and caches, ``lm_params_to_numpy`` gives the port's weights
back in that layout, and ``adamw_state_from_numpy`` carries the JAX
package's optimizer state into the port's.  bfloat16
leaves cross as float32 arrays (lossless) and are cast back to the
spec's dtype, which keeps ``ml_dtypes`` out of the port.  Only NumPy
crosses, so this module never imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hash_table import HashTable, JoinResult
from .partition import Partitions
from .relation import Relation, resolve_device

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


def from_numpy(cls, arrays, device=None):
    """A ``cls`` (one of Relation, HashTable, JoinResult, Partitions) from
    arrays in the order ``to_numpy`` gives (the JAX pytree-leaf order), on
    ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    arrays = [np.asarray(a) for a in arrays]
    if len(arrays) != _LEAVES[cls]:
        raise ValueError(f"{cls.__name__} takes {_LEAVES[cls]} arrays, got "
                         f"{len(arrays)}")
    ts = [torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
          for a in arrays]
    if cls is Partitions:
        return Partitions(Relation(ts[0], ts[1]), ts[2], ts[3])
    return cls(*ts)


def _tensors_like(specs: dict, tree: dict, model_dtype: str, device) -> dict:
    """``tree``'s arrays as tensors of the specs' shapes and dtypes."""
    from ..models.params import ParamSpec, torch_dtype

    if set(specs) != set(tree):
        raise ValueError(f"keys {sorted(tree)} differ from the specs' "
                         f"{sorted(specs)}")
    out = {}
    for k, spec in specs.items():
        if not isinstance(spec, ParamSpec):
            out[k] = _tensors_like(spec, tree[k], model_dtype, device)
            continue
        a = np.asarray(tree[k])
        if tuple(a.shape) != spec.shape:
            raise ValueError(f"{k}: shape {a.shape}, spec {spec.shape}")
        dt = torch_dtype(spec.dtype or model_dtype)
        out[k] = torch.from_numpy(np.array(a)).to(device, dt)
    return out


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """The port's ``LM`` holding the JAX package's parameters ``tree``
    (``jax.tree.map(np.asarray, params)``, bf16 leaves as float32), on
    ``device`` (the card unless told otherwise)."""
    from ..models import transformer as tfm

    device = resolve_device(device)
    return tfm.lm_from_tree(cfg, _tensors_like(tfm.param_specs(cfg), tree,
                                               cfg.dtype, device))


def lm_cache_from_numpy(cfg, tree: dict, device=None) -> dict:
    """The port's cache from a JAX serving cache of the same layout, on
    ``device`` (the card unless told otherwise)."""
    from ..models import transformer as tfm

    device = resolve_device(device)
    # (block, index of its batch axis): stacked unit leaves lead with n.
    blocks = [(b, 1) for b in tree["unit"].values()] + \
        [(b, 0) for b in tree.get("tail", {}).values()]
    batch = next(np.asarray(b[next(iter(b))]).shape[ax] for b, ax in blocks)
    s_max = next((np.asarray(b["k"]).shape[ax + 1] for b, ax in blocks
                  if "k" in b), 1)
    out = _tensors_like(tfm.cache_specs(cfg, batch, s_max), tree, cfg.dtype,
                        device)
    out["unit"] = tfm._unstack(out["unit"], cfg.num_units)
    return out


def stack_units(tree: dict) -> dict:
    """A tree of the port's model layout (``unit`` a list of units) in the
    JAX package's (``unit`` stacked along a leading axis), NumPy float32
    where a leaf is floating."""
    from .tree import tree_map

    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def stacked(units):
        return tree_map(lambda *xs: np.stack(xs), *units)

    out = tree_map(conv, tree)
    out["unit"] = stacked(out["unit"])
    if "encoder" in out:
        out["encoder"]["unit"] = stacked(out["encoder"]["unit"])
    return out


def lm_params_to_numpy(cfg, lm) -> dict:
    """The port's ``LM`` as the JAX package's parameter tree of NumPy
    arrays (``unit`` stacked, bf16 leaves as float32): the inverse of
    ``lm_params_from_numpy``."""
    from .tree import param_tree

    return stack_units(param_tree(lm))


def _unstacked_like(cfg, tree: dict, dtype, device) -> dict:
    """The JAX package's parameter-shaped ``tree`` as the port's layout,
    tensors of ``dtype`` on ``device``."""
    from ..models import transformer as tfm
    from .tree import tree_map

    out = tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device, dtype), tree)
    out["unit"] = tfm._unstack(out["unit"], cfg.num_units)
    if "encoder" in out:
        out["encoder"]["unit"] = tfm._unstack(out["encoder"]["unit"],
                                              cfg.encoder.num_layers)
    return out


def adamw_state_from_numpy(cfg, state: dict, state_dtype: str = "float32",
                           device=None) -> dict:
    """The port's AdamW state from the JAX package's (``jax.tree.map(
    np.asarray, opt_state)``, bf16 moments as float32): moments in
    ``state_dtype`` in the port's layout, the step an int32 tensor, on
    ``device`` (the card unless told otherwise)."""
    from ..models.params import torch_dtype

    device = resolve_device(device)
    dt = torch_dtype(state_dtype)
    return {"mu": _unstacked_like(cfg, state["mu"], dt, device),
            "nu": _unstacked_like(cfg, state["nu"], dt, device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
