"""Parameter specs: one source of truth for shapes, init, dtypes and
sharding.

Counterpart of ``repro/models/params.py``.  A model is described once as
a tree (nested dicts) of ``ParamSpec``:

  * tensors (``materialize``, drawn from an explicit ``torch.Generator``);
  * abstract tensors (``abstract``: meta tensors, or DTensors of meta
    local shards where a sharding is given, for the dry-run);
  * shardings (``shardings``: a ``Sharding`` per leaf by the logical-axis
    engine, ``distributed/sharding.py``), and ``distribute``, which puts
    full tensors onto them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "int32": torch.int32}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (or a torch dtype) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]     # logical axes, len == len(shape)
    init: str = "normal"             # normal | zeros | ones
    scale: float | None = None       # stddev override
    dtype: str | None = None         # override model dtype (e.g. f32 norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _fan_in(shape: tuple[int, ...]) -> int:
    # weights are (in_dims..., out_dims...): all dims but the last.
    return math.prod(shape[:-1]) if len(shape) > 1 else int(shape[0])


def leaves(spec_tree, prefix: str = ""):
    """``(path, spec)`` pairs in sorted-key order (the JAX pytree order)."""
    for k in sorted(spec_tree):
        v = spec_tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, ParamSpec):
            yield path, v
        else:
            yield from leaves(v, path + ".")


def materialize(spec_tree, generator: torch.Generator | None,
                dtype=torch.bfloat16, device=None) -> dict:
    """Tensors for every spec, drawn in ``leaves`` order from
    ``generator`` (on ``device``, which defaults to the generator's; a
    tree of only zeros and ones needs none): zeros, ones, or normal
    with stddev ``scale`` or 1/sqrt(fan-in), drawn in float32 and cast to
    the spec's dtype (the model's unless the spec names one)."""
    device = torch.device(device if device is not None
                          else generator.device)
    out: dict = {}
    for k in sorted(spec_tree):
        spec = spec_tree[k]
        if not isinstance(spec, ParamSpec):
            out[k] = materialize(spec, generator, dtype, device)
            continue
        dt = torch_dtype(spec.dtype) if spec.dtype else torch_dtype(dtype)
        if spec.init == "zeros":
            out[k] = torch.zeros(spec.shape, dtype=dt, device=device)
        elif spec.init == "ones":
            out[k] = torch.ones(spec.shape, dtype=dt, device=device)
        else:
            scale = spec.scale if spec.scale is not None \
                else 1.0 / max(1.0, _fan_in(spec.shape)) ** 0.5
            w = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=device)
            # Scaled in place: a full-width expert weight's float32 draw
            # is 20 GiB, and a second one would not fit beside it.
            out[k] = w.mul_(scale).to(dt)
    return out


def map_specs(fn, spec_tree, *rest):
    """``fn`` over the specs of a tree of dicts and lists (and over the
    leaves of trees of its shape in ``rest``)."""
    if isinstance(spec_tree, ParamSpec):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, list):
        return [map_specs(fn, s, *(r[i] for r in rest))
                for i, s in enumerate(spec_tree)]
    return {k: map_specs(fn, s, *(r[k] for r in rest))
            for k, s in spec_tree.items()}


def shardings(spec_tree, mesh, rules):
    """A ``Sharding`` (mesh, placements) for every spec, by its axes."""
    from ..distributed.sharding import make_sharding

    return map_specs(
        lambda s: make_sharding(mesh, rules, s.axes, s.shape), spec_tree)


def abstract(spec_tree, dtype=torch.bfloat16, *, shardings_tree=None,
             device="meta"):
    """A tensor with no data for every spec (its shape and dtype; the
    model's ``dtype`` unless the spec names one), or, with
    ``shardings_tree``, a DTensor of such local shards on each sharding:
    the dry-run's ``ShapeDtypeStruct``s.  On the meta device by default;
    under ``FakeTensorMode`` any ``device`` allocates nothing."""
    def one(s, sh=None):
        dt = torch_dtype(s.dtype) if s.dtype else torch_dtype(dtype)
        t = torch.empty(s.shape, dtype=dt, device=device)
        return t if sh is None else distribute(t, sh)
    if shardings_tree is None:
        return map_specs(one, spec_tree)
    return map_specs(one, spec_tree, shardings_tree)


def distribute(t: torch.Tensor, sharding) -> torch.Tensor:
    """The full tensor ``t`` as a DTensor on ``sharding`` (a DTensor is
    redistributed).  Every rank holds the same full tensor and keeps its
    own slice, so no rank sends anything and every mesh holds the same
    numbers; a meta tensor gives meta local shards."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, placements = sharding
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    if t.device.type not in ("meta", mesh.device_type):
        t = t.to(mesh.device_type)
    local = t
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(dim),
                                dim=p.dim)[mesh.get_local_rank(dim)]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def zeros_on(shape, dtype, sharding, device) -> torch.Tensor:
    """A DTensor of zeros of ``shape`` on ``sharding``: each rank
    allocates only its own shard, on ``device``."""
    from torch.distributed.tensor import DTensor

    meta = distribute(torch.empty(shape, dtype=dtype, device="meta"),
                      sharding)
    return DTensor.from_local(
        torch.zeros(meta.to_local().shape, dtype=dtype, device=device),
        sharding.mesh, sharding.placements, run_check=False,
        shape=meta.shape,
        stride=meta.stride())


def place(module: torch.nn.Module, spec_tree, mesh, rules):
    """Every parameter of ``module`` (a ``Params`` tree) distributed by
    its spec's sharding, in place.  ``spec_tree`` has the shape of
    ``core.tree.param_tree(module)``.  Returns ``module``."""
    from ..distributed.sharding import make_sharding

    def walk(mod, specs):
        if isinstance(mod, torch.nn.ModuleList):
            for m, sp in zip(mod, specs):
                walk(m, sp)
            return
        for name, p in list(mod._parameters.items()):
            s = specs[name]
            mod._parameters[name] = torch.nn.Parameter(
                distribute(p.detach(),
                           make_sharding(mesh, rules, s.axes, s.shape)),
                requires_grad=p.requires_grad)
        for name, child in mod.named_children():
            walk(child, specs[name])

    walk(module, spec_tree)
    return module


def spec_bytes(spec_tree, bytes_per_el: int = 2) -> int:
    return sum(math.prod(s.shape) * bytes_per_el
               for _, s in leaves(spec_tree))
