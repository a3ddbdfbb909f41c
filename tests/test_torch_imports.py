"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
imports jax or the JAX package repro."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.core.coprocess", "repro_torch.ops.groupby",
            "repro_torch.ops.join_variants",
            "repro_torch.kernels.agg.agg", "repro_torch.kernels.hash.hash",
            "repro_torch.kernels.partition_hist.partition_hist",
            "repro_torch.kernels.probe.ops",
            "repro_torch.kernels.probe.probe",
            "repro_torch.kernels.probe.ref",
            "repro_torch.configs.base", "repro_torch.configs.zamba2_1_2b",
            "repro_torch.models.params", "repro_torch.models.transformer",
            "repro_torch.layers.core", "repro_torch.layers.attention",
            "repro_torch.layers.ssd", "repro_torch.layers.moe",
            "repro_torch.kernels.flash_attn.flash_attn",
            "repro_torch.kernels.flash_attn.ops",
            "repro_torch.kernels.flash_attn.ref",
            "repro_torch.kernels.ssd.ssd", "repro_torch.kernels.ssd.ops",
            "repro_torch.kernels.ssd.ref", "repro_torch.serve.engine",
            "repro_torch.launch.serve",
            "repro_torch.obs", "repro_torch.obs.metrics",
            "repro_torch.obs.audit", "repro_torch.obs.cardinality",
            "repro_torch.obs.ledger", "repro_torch.obs.drift",
            "repro_torch.obs.slo", "repro_torch.obs.flight",
            "repro_torch.engine", "repro_torch.engine.admission",
            "repro_torch.engine.resilience", "repro_torch.engine.faults",
            "repro_torch.engine.table_cache", "repro_torch.engine.planner",
            "repro_torch.engine.service",
            "repro_torch.engine.workload",
            "repro_torch.core.allocator", "repro_torch.core.divergence",
            "repro_torch.queries", "repro_torch.queries.plan",
            "repro_torch.queries.optimize",
            "repro_torch.queries.executor",
            "repro_torch.core.tree", "repro_torch.core.interop",
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.train", "repro_torch.train.step",
            "repro_torch.train.compress", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.checkpoint",
            "repro_torch.checkpoint.store",
            "repro_torch.launch.train"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + sorted((ROOT / "tools").glob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), (path,
                                                                   name)
