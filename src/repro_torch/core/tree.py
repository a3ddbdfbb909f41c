"""Trees of tensors: nested dicts and lists, walked in the JAX pytree order.

The port's counterpart of what the JAX package takes from ``jax.tree``:
a dict's children in sorted-key order, a list's or tuple's in index
order, anything else a leaf.  ``param_tree`` views a module of the port's
``Params`` (an ``LM``) as such a tree of its parameters under the JAX
package's names, with ``unit`` a list of units; the optimizer and the
checkpoints work on these trees.
"""
from __future__ import annotations

from torch import nn


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_leaves(tree) -> list:
    """The leaves in pytree order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, c in kids for leaf in tree_leaves(c)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``; a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves; the path's keys and indices are
    joined by "/" (the JAX package's checkpoint keys)."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [(k, tree_map_with_path(fn, c, f"{prefix}/{k}" if prefix
                                  else str(k))) for k, c in kids]
    if isinstance(tree, dict):
        return dict(out)
    return type(tree)(v for _, v in out)


def flatten_with_paths(tree) -> dict:
    """``{path: leaf}`` in pytree order."""
    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def param_tree(module: nn.Module):
    """The parameters of ``module`` as a tree: a ``ModuleList`` is a list,
    any other module a dict of its own parameters and its children."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m) for m in module]
    out = dict(module._parameters)
    for name, child in module.named_children():
        out[name] = param_tree(child)
    return out


def as_tree(params):
    """``params`` as a tree: a module's ``param_tree``, a tree as it is."""
    return param_tree(params) if isinstance(params, nn.Module) else params
