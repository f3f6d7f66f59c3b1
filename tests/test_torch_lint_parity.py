"""Parity of the port lint with the JAX package's redlint, on the CPU: both
linters over the same sources must agree wherever a rule's spelling is the
same in both.

* the per-file rules whose spelling does not change (RED005, RED010,
  RED012, RED013, RED025), on every file of the port, chip_smoke.py and a
  few fixtures, and the waiver machinery (its parse, RED000, RED009 and
  --fix-stale-waivers' output text);
* the call graph (functions, edges, unresolved calls, thread roots, locks,
  spawn edges) each linter builds over the port, and the concurrency
  rules RED021-RED024 on it;
* the CLI's --format=json keys and its exit codes 0, 1 and 2.

Differences on purpose, and why:
* RED010's serve/ widening matches the literal "tpu_reductions/serve/" in
  the JAX rule and a `serve` path part in the port's (the literal is not a
  substring of "tpu_reductions_torch/serve/"), so the per-file comparison
  reports every port file under a `tpu_reductions/` prefix, where both
  read serve/ the same way.
* RED023's device-sync half reads each linter's SYNC facts: JAX's
  block_until_ready, the port's synchronize. The port holds neither under
  a lock, so the sets compared here agree; the torch spelling is held by
  tests/test_torch_lint_flow.py.
* The port's call sites also carry `device_arg` (how a call passes a card
  device), which the JAX graph has no field for; the graph is compared on
  the keys both have.
* The JAX lint also reads .sh files (RED008 and the shell half of
  RED013); the port has no shell scripts, so its lint reads .py only.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_reductions.lint import engine as jax_engine
from tpu_reductions.lint import fixers as jax_fixers
from tpu_reductions.lint import rules as jax_rules
# the JAX lint's flow package first: importing its conc package first
# runs into a circular import there
from tpu_reductions.lint.flow import dataflow as jax_flow
from tpu_reductions.lint.conc import analysis as jax_conc  # noqa: I100
from tpu_reductions_torch.lint import engine as port_engine
from tpu_reductions_torch.lint import fixers as port_fixers
from tpu_reductions_torch.lint import rules as port_rules
from tpu_reductions_torch.lint.conc import analysis as port_conc
from tpu_reductions_torch.lint.flow import dataflow as port_flow

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tpu_reductions_torch"
TARGETS = [PORT, REPO / "chip_smoke.py"]
SAME_SPELLING = ("RED005", "RED010", "RED012", "RED013", "RED025")
CONC = ("RED021", "RED022", "RED023", "RED024")

FIXTURES = {
    "utils/rows.py": 'ROW = "&&&& {name} DONE"\nOK = "&&&& x PASSED"\n',
    "utils/emit.py": ("def bad(ledger, rid):\n"
                      '    print(\'{"t": 1, "ev": "x.y", "pid": 2}\')\n'
                      "    ledger.emit('serve.launch', trace=rid)\n"
                      "    print(f'compiled in {rid:.2f}s')\n"),
    "bench/plan.py": "BUDGET_S = 600\nt = dict(budget_s=60)\n",
    "serve/state.py": ("import json\n"
                       "def save(p, f, rows):\n"
                       "    open(p, 'w')\n"
                       "    p.write_text('x')\n"
                       "    json.dump(rows, f)\n"),
    "bench/wired.py": ("from tpu_reductions_torch.utils import heartbeat\n"
                       "from tpu_reductions_torch.utils.retry import "
                       "retry_device_call\n"
                       "def run(fn):\n"
                       "    with heartbeat.guard('x'):\n"
                       "        return retry_device_call(fn)\n"),
}


def _sources():
    for f in sorted(PORT.rglob("*.py")):
        if "_build" not in f.parts:
            yield "tpu_reductions/" + f.relative_to(PORT).as_posix(), \
                f.read_text()
    yield "chip_smoke.py", (REPO / "chip_smoke.py").read_text()
    for rel, src in FIXTURES.items():
        yield "tpu_reductions/" + rel, src


def _per_file(check, rel, src):
    return sorted((f.rule, f.line) for f in check(rel, src)
                  if f.rule in SAME_SPELLING)


def test_per_file_rules_agree_on_the_port_and_fixtures():
    compared = 0
    for rel, src in _sources():
        want = _per_file(jax_rules.check_python, rel, src)
        got = _per_file(port_rules.check_python, rel, src)
        assert got == want, rel
        compared += len(want)
    # the waived sites of the tree and the fixtures: the comparison is
    # not an empty one
    assert compared >= 25, compared


# ------------------------------------------------------------- waivers

WAIVED = (
    "import json\n"
    "import functools\n"
    "def save(rows, f):\n"
    "    json.dump(rows, f)  # redlint: disable=RED010 -- a test pipe\n"
    "    # redlint: disable=RED010 -- standalone\n"
    "    json.dump(rows, f)\n"
    "    json.dump(rows, f)  # redlint: disable=RED010\n"
    "    x = 1  # redlint: disable=RED013 -- stale\n"
    '    s = "# redlint: disable=RED010 -- in a string"\n'
    "    # redlint: disable=RED013,RED010 -- two rules, one used\n"
    "    budget_s = 5\n"
    "# redlint: disable=RED025 -- above a decorator\n"
    "@functools.lru_cache\n"
    "def g():\n"
    "    pass\n")


def _waivers(mod):
    return [(w.line, w.rules, w.reason, w.applies_to)
            for w in mod._parse_waivers(WAIVED, True)]


def test_the_waiver_parse_agrees():
    assert _waivers(port_engine) == _waivers(jax_engine)
    assert len(_waivers(port_engine)) == 6


def test_red000_and_red009_agree(tmp_path):
    f = tmp_path / "w.py"
    f.write_text(WAIVED)

    def run(mod):
        return [(x.rule, x.line) for x in mod.lint_file(f)]
    assert run(port_engine) == run(jax_engine)
    assert {r for r, _ in run(port_engine)} == {"RED000", "RED009",
                                                "RED010"}


def test_fix_stale_waivers_writes_the_same_text(tmp_path):
    texts = []
    for mod in (jax_fixers, port_fixers):
        f = tmp_path / mod.__name__.split(".")[0] / "w.py"
        f.parent.mkdir()
        f.write_text(WAIVED)
        removed = mod.fix_stale_waivers([f], flow=False)
        texts.append((f.read_text(), [(ln, r) for _, ln, r in removed]))
    assert texts[0] == texts[1]
    assert texts[0][0] != WAIVED


# ------------------------------------------------------ the call graph


@pytest.fixture(scope="module")
def graphs():
    """Each linter's project over the port, its graph export and its
    concurrency findings."""
    py = port_engine.iter_lintable(TARGETS)
    rels = {f: str(f) for f in py}
    out = {}
    for name, flow, conc in (("jax", jax_flow, jax_conc),
                             ("port", port_flow, port_conc)):
        project = flow.build_cached_project(py, TARGETS, rels=rels)
        summaries = flow.compute_summaries(project)
        raws = conc.run_conc_rules(project, project.conc,
                                   summaries=summaries)
        out[name] = (json.loads(flow.export_graph(project, "json")),
                     sorted((Path(rel).relative_to(REPO).as_posix(),
                             f.rule, f.line)
                            for rel, lst in raws.items() for f in lst))
    return out


@pytest.mark.parametrize("key", ["modules", "edges",
                                 "dynamic_unresolved_calls", "locks",
                                 "thread_roots", "spawn_edges"])
def test_the_call_graph_agrees(graphs, key):
    assert graphs["port"][0][key] == graphs["jax"][0][key]
    assert graphs["port"][0][key]


def test_the_function_nodes_agree(graphs):
    def nodes(g):
        return [(n["id"], n["path"], n["line"], len(n["calls"]),
                 [(c["line"], c["raw"], c["target"], c["resolved"])
                  for c in n["calls"]]) for n in g["functions"]]
    assert nodes(graphs["port"][0]) == nodes(graphs["jax"][0])


def test_the_conc_findings_agree(graphs):
    port, jax = graphs["port"][1], graphs["jax"][1]
    assert port == jax
    # the four sites the port waives with the JAX package's reasons
    assert [(p, r) for p, r, _ in port] == [
        ("tpu_reductions_torch/faults/relay.py", "RED021")] * 3 + [
        ("tpu_reductions_torch/obs/trace.py", "RED023")]


# ----------------------------------------------------------------- CLI


def _cli(pkg, *args):
    return subprocess.run([sys.executable, "-m", f"{pkg}.lint", *args,
                           "--flow-cache="], capture_output=True,
                          text=True, cwd=REPO, timeout=120)


@pytest.mark.parametrize("case", ["clean", "finding", "usage"])
def test_the_cli_agrees(tmp_path, case):
    f = tmp_path / "x.py"
    f.write_text("x = 1\n" if case == "clean" else
                 "import json\ndef save(r, f):\n    json.dump(r, f)\n")
    args = ["--format=xml"] if case == "usage" else [str(f),
                                                      "--format=json"]
    jax, port = _cli("tpu_reductions", *args), _cli("tpu_reductions_torch",
                                                    *args)
    assert port.returncode == jax.returncode == \
        {"clean": 0, "finding": 1, "usage": 2}[case]
    if case != "usage":
        # the same keys and findings; a message may say it in torch terms
        def rows(proc):
            return [(sorted(r), r["rule"], r["path"], r["line"])
                    for r in json.loads(proc.stdout)]
        assert rows(port) == rows(jax)
