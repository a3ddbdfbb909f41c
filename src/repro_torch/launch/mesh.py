"""Mesh construction: ``torch.distributed.device_mesh.DeviceMesh``.

Counterpart of ``repro/launch/mesh.py``.  The production meshes keep the
JAX package's shapes and axis names, so every sharding decision is its:

  single pod: (16, 16) = 256 ranks, axes ("data", "model");
  multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model"); the
  "pod" axis is the slow link (the paper's discrete regime), so only
  coarse-grained (DP / compressed-gradient) traffic is mapped to it.

On H100s an NVLink domain is one node of 8 cards, so a 16-way "model"
axis spans two nodes and half of its traffic crosses InfiniBand.

A mesh needs a process group of its size.  ``make_production_mesh`` runs
on a real cluster of 256 / 512 ranks, or on the fake backend
(``launch/dryrun.py`` and the tests start it; no card and no data move).
``make_host_mesh`` is the mesh of the ranks ``torchrun`` started, on
their cards; one process alone makes a (1, 1) mesh on its card.
Importing this module starts nothing.
"""
from __future__ import annotations

import os

import torch


def _device_type(device) -> str:
    """"cuda" unless the caller asks for the CPU; raises without a card."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "mesh over gloo on the CPU")
    return kind


def ensure_process_group(device=None) -> None:
    """The default process group: the one already started, else the one
    ``torchrun``'s environment describes, else a group of this process
    alone (NCCL on a card, gloo on the CPU)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    kind = _device_type(device)
    backend = "nccl" if kind == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh_compat(shape, axes, devices=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default process group (``devices``: the device type, "cuda" by
    default)."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cpu" if devices == "cpu" else _device_type(devices)
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, devices)


def make_host_mesh(model: int | None = None, device=None):
    """(world // model, model) ("data", "model") over the ranks of the
    default process group, started here if none is (see
    ``ensure_process_group``)."""
    import torch.distributed as dist

    ensure_process_group(device)
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into model axis {model}")
    return make_mesh_compat((n // model, model), ("data", "model"), device)


# H100 SXM 80GB, per card: roofline and fit decisions.
HW = {
    # Dense bf16 tensor-core peak, no sparsity (NVIDIA H100 datasheet,
    # SXM5: 989.4 TFLOPS); PERF.md's bounds use the same figure.
    "peak_bf16_flops": 989e12,
    # HBM3 (NVIDIA H100 datasheet, SXM5: 3.35 TB/s).
    "hbm_bw": 3.35e12,
    # NVLink 4, one direction per card (datasheet: 900 GB/s both ways).
    "nvlink_bw": 450e9,
    # InfiniBand NDR 400 Gb/s, one ConnectX-7 per card in a DGX H100.
    "ib_bw": 50e9,
    # 80 GB of HBM3 (NVIDIA H100 datasheet), taken as 80 GiB.
    "hbm_bytes": 80 * 1024 ** 3,
}
