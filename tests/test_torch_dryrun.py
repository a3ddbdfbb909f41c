"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, on a small mesh.

The counterpart of tests/test_multidevice.py's
``test_dryrun_machinery_small_mesh``: reduced qwen3 at that test's widths
on a (2, 4) ("data", "model") mesh, ``ShapeSpec("t", 64, 8, "train")``
and the same sizes as a prefill and a decode.  The port's side runs on
the fake process group (8 ranks) in a subprocess, the JAX package's on 8
forced host devices in another (``repro/launch/dryrun.py`` sets
``XLA_FLAGS`` when imported, so neither runs in the pytest process).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

CELLS = (("t", "train"), ("p", "prefill"), ("d", "decode"))
COLLS = [{"kind": "all-gather", "dtype": "bf16", "bytes": 4096, "group": 16},
         {"kind": "all-reduce", "dtype": "f32", "bytes": 1024, "group": 2},
         {"kind": "reduce-scatter", "dtype": "bf16", "bytes": 256,
          "group": 16},
         {"kind": "all-to-all", "dtype": "s32", "bytes": 512, "group": 4},
         {"kind": "all-gather", "dtype": "f32", "bytes": 8, "group": 1}]

COMMON = r"""
import dataclasses, json, sys
CELLS = %r
COLLS = %r
def small(all_configs, reduced):
    cfg = reduced(all_configs()["qwen3_8b"])
    return dataclasses.replace(cfg, d_model=64, num_heads=8, num_kv_heads=4,
                               head_dim=16, d_ff=128)
class StandIn:
    def __init__(self, shape):
        self.shape = shape
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
""" % (CELLS, COLLS)

PORT_SIDE = COMMON + r"""
from repro.configs import all_configs, reduced, ShapeSpec
""".replace("from repro.configs", "from repro_torch.configs") + r"""
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.distributed.sharding import SERVE_RULES
dr.start_fake_group(8)
mesh = make_mesh_compat((2, 4), ("data", "model"), "cpu")
cfg = small(all_configs, reduced)
out = {"cells": {}}
for name, kind in CELLS:
    dr.SHAPES[name] = ShapeSpec(name, 64, 8, kind)
    out["cells"][kind] = dr.lower_cell("qwen3_8b", name, cfg=cfg, mesh=mesh,
                                       opt_dtype="float32")
out["link"] = dr.collective_link_bytes(COLLS)
out["by_kind"] = dr._by_kind(COLLS)
hw = json.loads(sys.argv[1])
out["serve_rules"] = {
    f"{a}/{m}": ("SERVE" if dr.serve_rules_for(c, StandIn(s), hw)
                 is SERVE_RULES else "TRAIN")
    for a, c in all_configs().items() for m, s in MESHES.items()}
out["opt_dtype"] = {f"{a}/{m}": dr.opt_dtype_for(c, StandIn(s), hw)
                    for a, c in all_configs().items()
                    for m, s in MESHES.items()}
print(json.dumps(out))
"""

JAX_SIDE = COMMON + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
from repro.configs import all_configs, reduced, ShapeSpec
from repro.distributed.sharding import SERVE_RULES
from repro.launch import dryrun as dr
from repro.launch.mesh import HW, make_mesh_compat
mesh = make_mesh_compat((2, 4), ("data", "model"))
cfg = small(all_configs, reduced)
out = {"cells": {}}
for name, kind in CELLS:
    shape = ShapeSpec(name, 64, 8, kind)
    dr.SHAPES[name] = shape
    compiled = dr._build_lowered(cfg, shape, mesh, None, "float32").compile()
    mem = compiled.memory_analysis()
    out["cells"][kind] = {"argument_bytes": mem.argument_size_in_bytes,
                          "collectives": len(dr.parse_collectives(
                              compiled.as_text()))}
out["link"] = dr.collective_link_bytes(COLLS)
out["by_kind"] = dr._by_kind(COLLS)
out["hw"] = HW
out["serve_rules"] = {
    f"{a}/{m}": ("SERVE" if dr.serve_rules_for(c, StandIn(s))
                 is SERVE_RULES else "TRAIN")
    for a, c in all_configs().items() for m, s in MESHES.items()}
# The JAX package chooses the moments' dtype inline in _build_lowered.
out["opt_dtype"] = {
    f"{a}/{m}": ("bfloat16" if c.param_count() * 16 / int(np.prod(
        list(s.values()))) > 0.6 * HW["hbm_bytes"] else "float32")
    for a, c in all_configs().items() for m, s in MESHES.items()}
print(json.dumps(out))
"""


def _env():
    return {"PYTHONPATH": str(ROOT / "src"),
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def sides():
    jax = subprocess.Popen([sys.executable, "-c", JAX_SIDE],
                           env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    out, err = jax.communicate(timeout=600)
    assert jax.returncode == 0, err[-4000:]
    want = json.loads(out.strip().splitlines()[-1])
    port = subprocess.run([sys.executable, "-c", PORT_SIDE,
                           json.dumps(want["hw"])], env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert port.returncode == 0, port.stderr[-4000:]
    return json.loads(port.stdout.strip().splitlines()[-1]), want


@pytest.mark.parametrize("kind", [k for _, k in CELLS])
def test_dryrun_cell_runs_on_the_fake_mesh(sides, kind):
    rep = sides[0]["cells"][kind]
    assert rep["status"] == "ok" and rep["mesh"] == "2x4"
    assert rep["devices"] == 8
    assert rep["flops_per_device"] > 0
    assert rep["collectives"]["count"] > 0
    assert rep["collectives"]["per_chip_link_bytes"] > 0
    for key in ("compile_s", "bytes_accessed_per_device"):
        assert rep[key] is None and rep["null_reasons"][key]
    assert rep["memory"]["code_bytes"] is None
    assert rep["memory"]["temp_bytes"] > 0


@pytest.mark.parametrize("kind", [k for _, k in CELLS])
def test_argument_bytes_match_xla(sides, kind):
    """Per-device argument bytes: the local shards of parameters, AdamW
    state and batch (train), of parameters and tokens (prefill), of
    parameters, cache and token (decode).  XLA's decode also counts its
    ``cache_len`` argument, an int32 scalar (4 bytes); the port's decode
    step takes it as a Python int."""
    got = sides[0]["cells"][kind]["memory"]["argument_bytes"]
    want = sides[1]["cells"][kind]["argument_bytes"]
    assert got == want - (4 if kind == "decode" else 0), (got, want)


def test_collective_link_bytes_and_by_kind_match(sides):
    port, jax = sides
    assert port["link"] == pytest.approx(jax["link"], rel=1e-12)
    assert port["by_kind"] == jax["by_kind"]


def test_serving_rules_and_moment_dtypes_match_on_the_references_hw(sides):
    port, jax = sides
    assert port["serve_rules"] == jax["serve_rules"]
    assert port["opt_dtype"] == jax["opt_dtype"]
    # llama4-400B keeps FSDP at serving time on v5e's 16 GiB.
    assert jax["serve_rules"]["llama4_maverick_400b/16x16"] == "TRAIN"


def test_h100_figures_change_the_decisions():
    """On 80 GiB the 16 x 16 mesh gives llama4 float32 moments (bfloat16
    on v5e's 16 GiB), and it still keeps FSDP at serving time."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import TRAIN_RULES
    from repro_torch.launch import dryrun as dr

    class StandIn:
        shape = {"data": 16, "model": 16}

    cfg = get_config("llama4_maverick_400b")
    assert dr.opt_dtype_for(cfg, StandIn()) == "float32"
    assert dr.serve_rules_for(cfg, StandIn()) is TRAIN_RULES


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=_env(), capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))


def test_cli_reports_a_skipped_cell():
    r = _cli("--arch", "qwen3_8b", "--shape", "long_500k")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SKIP qwen3_8b x long_500k" in r.stdout
    assert "dry-run complete" in r.stdout


def test_cli_fails_on_a_failed_cell():
    r = _cli("--arch", "no_such_arch", "--shape", "train_4k")
    assert r.returncode != 0
    assert "FAIL no_such_arch x train_4k" in r.stdout
