"""Parameter specs: one source of truth for shapes, init rules and dtypes.

Counterpart of ``repro/models/params.py``.  A model is described once as
a tree (nested dicts) of ``ParamSpec``; ``materialize`` turns it into
tensors with an explicit ``torch.Generator``.  The JAX package's
``abstract`` and ``shardings`` serve its dry-run and mesh and are not
ported.  ``axes`` keeps the JAX package's logical axis names so the specs
read the same; nothing in the port shards by them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


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


def spec_bytes(spec_tree, bytes_per_el: int = 2) -> int:
    return sum(math.prod(s.shape) * bytes_per_el
               for _, s in leaves(spec_tree))
