"""Logical-axis sharding rules (MaxText-style), with divisibility fallback.

Counterpart of ``repro/distributed/sharding.py``.  Tensors are annotated
with *logical* axis names; a rule table maps each logical axis to an
ordered list of candidate mesh axes.  The engine assigns, in *priority*
order (not tensor-dim order), the first candidate mesh axis that (a)
divides the dimension and (b) is not already used by the tensor.  The
rule tables and the engine are the JAX package's, entry for entry, so
every sharding decision is the same:

  * 40-head archs (qwen2.5, llama4, whisper): "heads" fails 16-way TP and
    their attention is replicated over the model axis.
  * 8-KV-head GQA decode: "kv_heads" fails, so KV caches shard on
    "cache_seq".
  * granite's 40 experts fail expert-parallel 16-way, so expert weights
    fall back to TP over the expert FFN dim ("expert_mlp").

``axes_to_spec`` returns the JAX ``PartitionSpec``'s entries as a tuple
(``None``, a mesh axis name, or a tuple of names per tensor dim) and reads
only ``mesh.shape`` (a mapping of axis name to size: a ``DeviceMesh``
through ``mesh_shape`` below, or any stand-in).  The port's
``NamedSharding`` is a ``(DeviceMesh, placements)`` pair (``Sharding``):
``Shard(d)`` on each mesh dim that a tensor dim ``d`` is split over, in
the mesh's order (JAX's major-to-minor within a tuple), ``Replicate()``
elsewhere.

``shard(x, *axes)`` is ``with_sharding_constraint``: under a context it
redistributes a DTensor to the rules' placements, which never changes its
values; without a context, or on a plain tensor, it returns ``x`` itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (priority, logical_axis -> mesh-axis candidates) table."""

    rules: tuple[tuple[str, tuple[str, ...]], ...]

    def candidates(self, name: str) -> tuple[str, ...]:
        for k, v in self.rules:
            if k == name:
                return v
        return ()

    def priority(self, name: str) -> int:
        for i, (k, _) in enumerate(self.rules):
            if k == name:
                return i
        return len(self.rules)


# Priority order matters: e.g. "heads" grabs the model axis before "q_seq".
TRAIN_RULES = ShardingRules((
    ("batch", ("pod", "data")),
    ("experts", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("mlp", ("model",)),
    ("expert_mlp", ("model",)),
    ("vocab", ("model",)),
    ("ssm_heads", ("model",)),
    # No head_dim / q_seq fallback for head counts the model axis does not
    # divide (qwen2.5 / llama4: 40, whisper: 20, granite: 24): their
    # attention is replicated over the model axis.
    ("q_seq", ()),
    ("head_dim", ()),
    ("expert_cap", ("model",)),  # expert capacity dim when experts don't
    ("fsdp", ("data",)),        # ZeRO-3 dim of parameters
    ("ssm_state", ()),
    ("conv", ()),
    ("seq", ("model",)),        # SP: residual stream sequence-sharded
    ("layers", ()),
    ("moe_group", ("pod", "data")),
))

# Pure HSDP: the batch shards over every mesh axis, weights are ZeRO-3
# sharded on their fsdp / TP dims and gathered per layer; attention is
# batch-local.
DP_RULES = ShardingRules((
    ("batch", ("pod", "data", "model")),
    ("experts", ("model",)),
    ("heads", ()),              # no TP: attention is batch-local
    ("kv_heads", ()),
    ("mlp", ("model",)),        # weight-shard dim (gathered per layer)
    ("expert_mlp", ("model",)),
    ("vocab", ("model",)),
    ("ssm_heads", ()),
    ("q_seq", ()),
    ("head_dim", ()),
    ("expert_cap", ()),
    ("fsdp", ("data",)),
    ("ssm_state", ()),
    ("conv", ()),
    ("seq", ()),
    ("layers", ()),
    ("moe_group", ("pod", "data", "model")),
))

SERVE_RULES = ShardingRules((
    ("batch", ("pod", "data")),
    ("experts", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("cache_seq", ("model",)),  # KV cache sequence sharding (flash-decode)
    ("mlp", ("model",)),
    ("expert_mlp", ("model",)),
    ("vocab", ("model",)),
    ("ssm_heads", ("model",)),
    ("q_seq", ()),
    ("head_dim", ()),
    ("expert_cap", ("model",)),
    ("fsdp", ()),               # weights stay TP-only at serving time
    ("ssm_state", ()),
    ("conv", ()),
    ("seq", ("model",)),
    ("layers", ()),
    ("moe_group", ("pod", "data")),
))

Spec = tuple  # per tensor dim: None, a mesh axis name or a tuple of names


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or ``mesh.shape`` of a
    stand-in that has a mapping there)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axes_to_spec(axes: tuple[str | None, ...], dims: tuple[int, ...],
                 rules: ShardingRules, mesh) -> Spec:
    """Assign mesh axes to tensor dims by rule priority with divisibility."""
    assert len(axes) == len(dims), (axes, dims)
    shape = mesh_shape(mesh)
    assignment: dict[int, tuple[str, ...]] = {}
    used: set[str] = set()
    order = sorted((i for i, a in enumerate(axes) if a),
                   key=lambda i: rules.priority(axes[i]))
    for i in order:
        got: list[str] = []
        size = dims[i]
        for cand in rules.candidates(axes[i]):
            if cand in used or cand not in shape:
                continue
            if size % shape[cand] == 0 and size > 0:
                got.append(cand)
                used.add(cand)
                size //= shape[cand]
        if got:
            assignment[i] = tuple(got)
    return tuple(None if i not in assignment
                 else (assignment[i][0] if len(assignment[i]) == 1
                       else assignment[i])
                 for i in range(len(axes)))


def spec_to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``:
    ``Shard(d)`` on every mesh dim of more than one rank that tensor dim
    ``d`` names, else ``Replicate()``.  On a mesh dim of one rank a shard
    is the whole tensor, so both placements hold the same data;
    ``Replicate`` keeps DTensor's sharding rules out of the way where
    they refuse a split dim (torch 2.11 will not flatten two split dims
    into a matmul, or split a dim of length 1)."""
    from torch.distributed.tensor import Replicate, Shard

    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            where[name] = d
    sizes = mesh_shape(mesh)
    return tuple(Shard(where[n]) if n in where and sizes[n] > 1
                 else Replicate() for n in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh and one placement per mesh
    dim (a leaf of a tree, not a container)."""

    mesh: object
    placements: tuple

    def __iter__(self):
        return iter((self.mesh, self.placements))


# --------------------------------------------------------------------------
# Context: current mesh + rules, so layers can annotate activations.
# --------------------------------------------------------------------------

_ctx = threading.local()
redistributes = 0  # redistributions ``shard`` made since the last reset


view_fallbacks = 0  # DTensor views that DTensor's own rule refused and
#                     that were redistributed (each distinct shape once)
_view_depth = 0
_relaxed: dict = {}


@contextlib.contextmanager
def _views_may_redistribute():
    """Inside the outermost mesh context only, a DTensor ``view`` (and
    ``_unsafe_view``, which autograd and ``matmul`` use) that DTensor's
    own rule refuses is redistributed as its ``reshape`` would be,
    instead of raising.  DTensor (torch 2.11 more often than 2.13) cannot
    merge a split dim into a dim on its left, or split a dim that several
    mesh dims split, without moving data; GSPMD moves it there too.  The
    own rule is always tried first; each fallback adds one to
    ``view_fallbacks`` and its collectives show in CommDebugMode.  On
    leaving, the own rules come back, and the sharding cache is cleared
    if a fallback filled it, so no view outside a mesh context moves
    data."""
    global _view_depth
    _view_depth += 1
    if _view_depth > 1:
        try:
            yield
        finally:
            _view_depth -= 1
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops as vo

    prop = DTensor._op_dispatcher.sharding_propagator
    ops = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
    saved = {op: (prop.op_strategy_funcs.get(op),
                  prop.op_to_schema_info.get(op)) for op in ops}
    before = view_fallbacks
    for op in ops:
        own = saved[op][0]
        if op not in _relaxed:   # DTensor's reshape rule, made once
            vo.register_op_strategy_map(op, torch.Tensor.view,
                                        schema_info=RuntimeSchemaInfo(1),
                                        strict_view=False)
            _relaxed[op] = prop.op_strategy_funcs[op]
        relaxed = _relaxed[op]

        def either(op_schema, _own=own, _relaxed=relaxed):
            if _own is not None:
                try:
                    return _own(op_schema)
                except RuntimeError:
                    pass
            global view_fallbacks
            view_fallbacks += 1
            return _relaxed(op_schema)
        prop.op_strategy_funcs[op] = either
    try:
        yield
    finally:
        _view_depth -= 1
        for op, (fn, info) in saved.items():
            for table, value in ((prop.op_strategy_funcs, fn),
                                 (prop.op_to_schema_info, info)):
                if value is None:
                    table.pop(op, None)
                else:
                    table[op] = value
        if view_fallbacks != before:
            prop.propagate_op_sharding.cache_clear()
            native = getattr(torch._C,
                             "_clear_DTensor_sharding_propagator_cache", None)
            if native is not None:  # the C++ dispatch's own cache
                native()


@contextlib.contextmanager
def shard_ctx(mesh, rules: ShardingRules | None):
    """Layers see ``mesh`` and ``rules`` through ``shard``.  With a mesh,
    a plain tensor that meets a DTensor in an op (positions, masks) counts
    as replicated, and a view DTensor refuses redistributes
    (``_views_may_redistribute``)."""
    prev = getattr(_ctx, "val", None)
    _ctx.val = (mesh, rules)
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with _views_may_redistribute(), implicit_replication():
                yield
    finally:
        _ctx.val = prev


def current_mesh():
    v = getattr(_ctx, "val", None)
    return v[0] if v else None


def current_rules() -> ShardingRules | None:
    v = getattr(_ctx, "val", None)
    return v[1] if v else None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_range(x, dim: int) -> tuple[int, int]:
    """[lo, hi) of tensor dim ``dim`` that this rank holds of the DTensor
    ``x`` (split over the mesh dims that shard it, in mesh order)."""
    from torch.distributed.tensor import Shard

    lo, size = 0, x.shape[dim]
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= x.device_mesh.size(m)
            lo += x.device_mesh.get_local_rank(m) * size
    return lo, lo + size


def check_placements(name: str, x, allowed: tuple[int, ...]) -> None:
    """Raise unless every placement of the DTensor ``x`` is Replicate or
    a Shard of one of the tensor dims ``allowed``: a kernel takes its
    local shard as it is and gathers nothing."""
    from torch.distributed.tensor import Replicate, Shard

    for p in x.placements:
        if not (isinstance(p, Replicate)
                or (isinstance(p, Shard) and p.dim in allowed)):
            raise ValueError(f"{name}: placement {p} of {tuple(x.shape)} is "
                             f"not one the kernel takes (Replicate or "
                             f"Shard of dims {allowed})")


def placements_for(axes: tuple[str | None, ...], dims: tuple[int, ...],
                   rules: ShardingRules, mesh) -> tuple:
    return spec_to_placements(axes_to_spec(axes, dims, rules, mesh), mesh)


def elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``; on a DTensor each rank applies
    it to its shard through ``local_map`` (for ops that DTensor has no
    rule for in some torch versions: ``softplus`` in 2.11)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map

    p = list(x.placements)
    return local_map(fn, out_placements=p, in_placements=(p,),
                     in_grad_placements=(p,), device_mesh=x.device_mesh)(x)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain an activation to the logical ``axes``' placements: a
    DTensor is redistributed (its values stay the same); without a
    context, or on a plain tensor, ``x`` itself comes back."""
    mesh, rules = (getattr(_ctx, "val", None) or (None, None))
    if mesh is None or rules is None or not is_dtensor(x):
        return x
    want = placements_for(tuple(axes), tuple(x.shape), rules, mesh)
    if tuple(x.placements) == want:
        return x
    global redistributes
    redistributes += 1
    out = x.redistribute(mesh, want)
    local = out.to_local()
    if local.is_contiguous():
        return out
    # A shard cut from a replica along an inner dim is a strided view of
    # it, while the DTensor reports contiguous strides: a later view of
    # the local tensor would fail.
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), mesh, want,
                              run_check=False, shape=out.shape,
                              stride=out.stride())


def make_sharding(mesh, rules: ShardingRules,
                  axes: tuple[str | None, ...],
                  dims: tuple[int, ...]) -> Sharding:
    return Sharding(mesh, placements_for(axes, dims, rules, mesh))


def spec_for_tree(axes_tree, shape_tree, rules: ShardingRules, mesh):
    """Map a tree of logical-axis tuples and a tree of the same structure
    whose leaves have ``.shape`` to ``Sharding``s."""
    def is_axes(x):
        return isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x)

    def walk(axes, shp):
        if is_axes(axes):
            return make_sharding(mesh, rules, tuple(axes), tuple(shp.shape))
        if isinstance(axes, dict):
            return {k: walk(axes[k], shp[k]) for k in axes}
        return type(axes)(walk(a, s) for a, s in zip(axes, shp))

    return walk(axes_tree, shape_tree)
