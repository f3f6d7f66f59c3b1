"""The port's own clean gate: the port lint over tpu_reductions_torch/ and
chip_smoke.py gives no finding of any rule, RED006 included, with the
flow and concurrency layers on and off and with the fact cache cold and
warm, as tests/test_lint_clean.py holds the JAX tree. RED006's pin, and
chip_smoke.py's copy of it, stay at 0. The lint itself runs with neither
torch nor jax."""

import ast
import json
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_reductions_torch.lint.engine import lint_paths, summarize

REPO = Path(__file__).resolve().parents[1]
TARGETS = [REPO / "tpu_reductions_torch", REPO / "chip_smoke.py"]

# RED006's findings on the tree: every public ops/bench docstring cites
# its JAX or reference line, or states that it has none
RED006_PINNED = 0


@pytest.fixture(scope="module")
def passes(tmp_path_factory):
    """One lint of the port per mode, shared by the tests below."""
    cache = tmp_path_factory.mktemp("lint") / "cache.json"
    cold = lint_paths(TARGETS, flow_cache=cache)
    assert cache.exists()
    warm = lint_paths(TARGETS, flow_cache=cache)
    return {"flow, cold cache": cold, "flow, warm cache": warm,
            "no flow": lint_paths(TARGETS, flow=False)}


@pytest.mark.parametrize("mode", ["flow, cold cache", "flow, warm cache",
                                  "no flow"])
def test_the_port_is_clean_but_red006(passes, mode):
    """No finding of any rule: RED006 is no longer an exception."""
    assert passes[mode] == [], "\n" + "\n".join(
        f.render() for f in passes[mode])


@pytest.mark.parametrize("mode", ["flow, cold cache", "flow, warm cache",
                                  "no flow"])
def test_red006_stays_at_or_under_its_pin(passes, mode):
    n = summarize(passes[mode]).get("RED006", 0)
    assert n <= RED006_PINNED, n


def test_every_red006_is_in_ops_or_bench(passes):
    dirs = {Path(f.path).relative_to(REPO).parts[1]
            for f in passes["no flow"] if f.rule == "RED006"}
    assert dirs <= {"ops", "bench"}


def test_the_modes_agree(passes):
    assert passes["flow, cold cache"] == passes["flow, warm cache"] \
        == passes["no flow"]


def test_the_cli_runs_without_torch_or_jax(tmp_path):
    """The lint's CLI, as chip_smoke.py's [lint] phase runs it, over a
    small tree: JSON out, exit 1 on a finding, and neither torch nor jax
    nor the JAX package is loaded."""
    (tmp_path / "bench").mkdir()
    (tmp_path / "bench" / "x.py").write_text(
        "import json\ndef save(rows, f):\n    json.dump(rows, f)\n")
    code = (
        "import runpy, sys\n"
        "sys.argv = ['lint', sys.argv[1], '--format=json', "
        "'--flow-cache=']\n"
        "try:\n"
        "    runpy.run_module('tpu_reductions_torch.lint', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'tpu_reductions'))\n"
        "print('RC', rc, 'BAD', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    head, _, tail = proc.stdout.rpartition("RC ")
    assert tail.split() == ["1", "BAD", "[]"], proc.stdout
    rows = json.loads(head)
    assert [(r["rule"], r["line"]) for r in rows] == [("RED006", 1),
                                                      ("RED006", 2),
                                                      ("RED010", 3)]


def test_chip_smokes_pin_is_this_pin():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    pins = [node.value.value for node in tree.body
            if isinstance(node, ast.Assign)
            and [getattr(t, "id", "") for t in node.targets]
            == ["LINT_RED006_PINNED"]]
    assert pins == [RED006_PINNED]


def test_chip_smokes_lint_phase_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                                      capsys):
    """The [lint] phase's own function, run here: two passes in
    processes of their own, the second through the cache the first
    wrote, both with exit 0 and no finding."""
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="not_main")
    monkeypatch.chdir(tmp_path)
    smoke["lint_path"](None, {}, None, None, None, None)
    out = capsys.readouterr().out
    assert "cold pass: exit 0" in out and "warm pass: exit 0" in out
    assert out.count(" 0 findings []") == 2, out
    assert (tmp_path / "out" / "lint_cache.json").exists()
    assert "lint" in smoke["CLI_PATHS"]
