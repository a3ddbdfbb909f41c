"""The port's logical-axis rule engine against the JAX package's.

``axes_to_spec`` must give the JAX package's ``PartitionSpec`` entries for
every leaf of every config's ``param_specs``, ``cache_specs`` (at
``decode_32k``) and ``batch_specs`` (at ``train_4k``), at full width,
under all three rule tables, on the (1, 1), (2, 4), (16, 16) and
(2, 16, 16) axis sizes.  Both sides read a stand-in mesh that has only
``.shape``, as tests/test_layers.py does, so no devices are needed.
Then ``shard`` without a context, placements on one-rank mesh dims,
the H100 figures, and ``make_host_mesh`` without a card."""
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.models import transformer as jtfm
from repro.models.params import ParamSpec as JParamSpec
from repro.train import step as jstep
from repro_torch.distributed import sharding as tsh
from repro_torch.models import transformer as ttfm
from repro_torch.models.params import ParamSpec, leaves
from repro_torch.train import step as tstep

MESHES = {"1x1": {"data": 1, "model": 1}, "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = ("TRAIN_RULES", "DP_RULES", "SERVE_RULES")


class StandIn:
    """A mesh with only its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jleaves(tree, prefix=""):
    if isinstance(tree, JParamSpec):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _jleaves(tree[k], f"{prefix}.{k}" if prefix else k)


def _spec_trees(arch):
    """(name, JAX spec tree, port spec tree) of the three kinds."""
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    d32, t4k = JSHAPES["decode_32k"], JSHAPES["train_4k"]
    tshape = tconfigs.SHAPES["train_4k"]
    return [("params", jtfm.param_specs(jcfg), ttfm.param_specs(tcfg)),
            ("cache", jtfm.cache_specs(jcfg, d32.global_batch, d32.seq_len),
             ttfm.cache_specs(tcfg, d32.global_batch, d32.seq_len)),
            ("batch", jstep.batch_specs(jcfg, t4k),
             tstep.batch_specs(tcfg, tshape))]


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(tconfigs.all_configs()))
def test_axes_to_spec_matches_jax_on_every_leaf(arch, mesh, rules):
    stand_in = StandIn(MESHES[mesh])
    jr, tr = getattr(jsh, rules), getattr(tsh, rules)
    assert tr == tsh.ShardingRules(jr.rules)
    n = 0
    for kind, jtree, ttree in _spec_trees(arch):
        jl, tl = dict(_jleaves(jtree)), dict(leaves(ttree))
        assert set(jl) == set(tl), kind
        for path, ts in tl.items():
            js = jl[path]
            assert (js.shape, js.axes) == (ts.shape, ts.axes), (kind, path)
            want = tuple(jsh.axes_to_spec(js.axes, js.shape, jr, stand_in))
            got = tsh.axes_to_spec(ts.axes, ts.shape, tr, stand_in)
            assert got == want, (kind, path, got, want)
            n += 1
    assert n > 10


def test_spec_to_placements_orders_mesh_axes():
    """A dim split over ("pod", "data") shards on both mesh dims, in the
    mesh's order; a dim of length 1 stays whole."""
    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    class Mesh21:
        mesh_dim_names = ("data", "model")
        shape = (2, 1)

    from torch.distributed.tensor import Replicate, Shard

    spec = (("pod", "data"), None, "model")
    assert tsh.spec_to_placements(spec, Mesh3()) == (Shard(0), Shard(0),
                                                    Shard(2))
    # The engine gives "seq" the one-rank model axis; on a mesh dim of
    # one rank the placement is Replicate (the same data).
    assert tsh.axes_to_spec(("batch", "seq", None), (64, 1, 32),
                            tsh.TRAIN_RULES, _OneRank()) == \
        ("data", "model", None)
    got = tsh.placements_for(("batch", "seq", None), (64, 1, 32),
                             tsh.TRAIN_RULES, _OneRank())
    assert got == (Replicate(), Replicate()), got
    got = tsh.placements_for(("batch", "seq", None), (64, 8, 32),
                             tsh.TRAIN_RULES, Mesh21())
    assert got == (Shard(0), Replicate()), got


class _OneRank:
    mesh_dim_names = ("data", "model")
    shape = (1, 1)


def test_shard_without_a_context_is_the_identity():
    x = torch.ones(2, 3)
    assert tsh.shard(x, "batch", None) is x
    with tsh.shard_ctx(None, tsh.TRAIN_RULES):
        assert tsh.shard(x, "batch", None) is x
    assert tsh.current_mesh() is None and tsh.current_rules() is None


def test_shard_ctx_nests_and_restores():
    with tsh.shard_ctx(None, tsh.SERVE_RULES):
        assert tsh.current_rules() is tsh.SERVE_RULES
        with tsh.shard_ctx(None, tsh.TRAIN_RULES):
            assert tsh.current_rules() is tsh.TRAIN_RULES
        assert tsh.current_rules() is tsh.SERVE_RULES
    assert tsh.current_rules() is None


def test_hw_is_the_h100s():
    from repro_torch.launch.mesh import HW

    assert HW["peak_bf16_flops"] == 989e12 and HW["hbm_bw"] == 3.35e12
    assert HW["hbm_bytes"] == 80 * 1024 ** 3
    assert {"nvlink_bw", "ib_bw"} <= set(HW)


def test_host_mesh_raises_without_a_card():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    assert not dist.is_initialized()


def test_port_spec_trees_use_the_port_paramspec():
    for _, _, ttree in _spec_trees("zamba2_1_2b"):
        assert all(isinstance(s, ParamSpec) for _, s in leaves(ttree))


VIEW_SCOPE = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.dryrun import comm_counter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
# global (3, 2, 4), dim 0 split unevenly over "model": DTensor's own
# view rule refuses to flatten it
x = DTensor.from_local(torch.randn(2, 2, 4), mesh, [Replicate(), Shard(0)],
                       run_check=False, shape=(3, 2, 4), stride=(8, 4, 1))


def view():
    try:
        with comm_counter() as comm:
            y = x.view(24)
    except RuntimeError:
        return "refused"
    return (str(y.placements), comm.get_total_counts(),
            tsh.view_fallbacks)


print(view())
with tsh.shard_ctx(mesh, tsh.TRAIN_RULES):
    with tsh.shard_ctx(mesh, tsh.TRAIN_RULES):
        pass
    print(view())
print(view())
dist.destroy_process_group()
"""


def test_views_redistribute_only_inside_a_mesh_context():
    """A view DTensor's own rule refuses raises outside ``shard_ctx``,
    is redistributed (one all-gather, one fallback counted) inside it,
    also after an inner context has closed, and raises again after."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = {"PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "1",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp")}
    r = subprocess.run([sys.executable, "-c", VIEW_SCOPE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[:3] == [
        "refused", "('(Replicate(), Replicate())', 1, 1)", "refused"], \
        r.stdout
