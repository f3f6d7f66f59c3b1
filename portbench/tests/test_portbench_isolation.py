"""Nothing under portbench/ imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain references import nothing of the port. A run
of each cell on the CPU loads none of them either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_reductions"}
ROOT = harness.BENCH_DIR


def _imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(node.args[0].value.split(".")[0])
    return tops


SOURCES = sorted(ROOT.rglob("*.py"))


def test_the_scan_sees_every_source():
    assert len(SOURCES) > 20
    assert "tpu_reductions_torch" in _imported_tops(
        ROOT / "drivers" / "single_device.py")


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    assert "tpu_reductions_torch" not in _imported_tops(path)
    assert not _imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("cell", ["sdk_reduction.awaited-2gib",
                                  "mpi_reduce.vn8-root-2gib"])
def test_a_run_loads_no_jax(cell):
    code = f"""
import json
from portbench import harness
from portbench.tests import full_spec
def go():
    cell = harness.resolve(full_spec(), {cell!r})
    cell.traffic = dict(cell.traffic, n={{"int32": 4096, "float64": 4096}},
                        bytes_per_dtype=8 * 8 * 512)
    out = harness.run_cell(cell, 11, 0.3, False, platform="cpu")
    print(json.dumps([out.correct, harness.forbidden_modules(),
                      out.forbidden]))
if __name__ == "__main__":
    go()
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240, cwd=ROOT.parent)
    assert p.returncode == 0, p.stderr[-3000:]
    correct, here, workers = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct is True
    assert here == [] and workers == []
