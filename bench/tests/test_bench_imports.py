"""No module a run of any cell loads is ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` (top-level names compared whole, so
``repro_torch`` passes), and the references load nothing of the port."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
         ] + ["ssb_sf2.flights23"]          # built, not yet a cell

RUN = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import bench.run, bench.control
from bench.tests import _tiny
for trace in (False, True):
    _tiny.run({cell!r}, seconds=0.5, trace=trace)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFS = """
import json, sys
sys.path[:0] = [{root!r}]
import bench.reference.join, bench.reference.ssb, bench.data.relations
import bench.data.ssb, bench.roofline
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                              "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    tops = _loaded(RUN.format(src=str(ROOT / "src"), root=str(ROOT),
                              cell=cell))
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


def test_run_py_names_what_it_finds():
    sys.path.insert(0, str(ROOT))
    from bench import run
    before = dict(sys.modules)
    try:
        sys.modules["repro.core"] = sys.modules["json"]
        assert run.forbidden_modules() == ["repro"]
        del sys.modules["repro.core"]
        sys.modules["repro_torch_x"] = sys.modules["json"]
        assert run.forbidden_modules() == [] or "jax" in before
    finally:
        sys.modules.pop("repro.core", None)
        sys.modules.pop("repro_torch_x", None)


def test_references_load_nothing_of_the_port():
    tops = _loaded(REFS.format(root=str(ROOT)))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
