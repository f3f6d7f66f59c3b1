"""The port lint's per-file rules, one violating and one clean fixture per
rule in torch spellings, the waiver machinery (RED000, RED009, standalone
and trailing waivers, waivers written inside strings), the fixers and the
CLI's contract (python -m tpu_reductions_torch.lint)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_reductions_torch.lint import grammar
from tpu_reductions_torch.lint.engine import lint_file, lint_paths
from tpu_reductions_torch.lint.fixers import (MARKER, fix_docstrings,
                                              fix_stale_waivers)

REPO = Path(__file__).resolve().parents[1]


def _lint(tmp_path, src, name="fixture.py"):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    return lint_file(f)


def _rules(findings):
    return [f.rule for f in findings]


def _lines(findings, rule):
    return [f.line for f in findings if f.rule == rule]


# Each case: (rule, path, violating source, lines it fires on, clean
# source). The clean source is the same pattern spelled the port's way
# (or in its home), and must give no finding of that rule.
CASES = [
    ("RED002", "bench/timing_probe.py",
     "import time\nimport torch\n"
     "def bench(f, x):\n"
     "    t0 = time.perf_counter()\n"
     "    f(x)\n"
     "    torch.cuda.synchronize()\n"
     "    return time.perf_counter() - t0\n",
     [4, 7],
     "import time\n"
     "def host_only(f):\n"
     "    t0 = time.perf_counter()\n"
     "    f()\n"
     "    return time.perf_counter() - t0\n"),
    ("RED002", "bench/event_sync.py",
     "from time import perf_counter as clock\n"
     "def bench(f, done):\n"
     "    t0 = clock()\n"
     "    f()\n"
     "    done.synchronize()\n"
     "    return clock() - t0\n",
     [3, 6],
     "from time import perf_counter as clock\n"
     "def bench(f, done):\n"
     "    f()\n"
     "    done.synchronize()\n"
     "def other():\n"
     "    return clock()\n"),
    ("RED005", "utils/rows.py",
     'ROW = "&&&& {name} DONE"\n',
     [1],
     "from tpu_reductions_torch.lint.grammar import QA_FINISH_TEMPLATE\n"
     "ROW = QA_FINISH_TEMPLATE\n"),
    ("RED006", "ops/thing.py",
     '"""The module (reduction.cpp:10)."""\n'
     "def public():\n"
     '    """No citation here."""\n',
     [2],
     '"""The module (reduction.cpp:10)."""\n'
     "def public():\n"
     '    """Mirrors ops/pallas_reduce.py:390."""\n'
     "def other():\n"
     '    """No reference analog (port-native)."""\n'),
    ("RED010", "bench/artifact.py",
     "import json\n"
     "def save(path, rows):\n"
     "    with open(path, 'w') as f:\n"
     "        json.dump(rows, f)\n"
     "    path.write_text(json.dumps(rows))\n",
     [4, 5],
     "from tpu_reductions_torch.utils.jsonio import atomic_json_dump\n"
     "def save(path, rows):\n"
     "    atomic_json_dump(path, rows)\n"
     "    print(json.dumps(rows))\n"),
    ("RED010", "tpu_reductions_torch/serve/state.py",
     "def save(path, text):\n"
     "    with open(path, 'a') as f:\n"
     "        f.write(text)\n"
     "    path.write_bytes(b'x')\n",
     [2, 4],
     "def load(path):\n"
     "    with open(path) as f:\n"
     "        return f.read()\n"),
    ("RED011", "bench/entry.py",
     "import torch\n"
     "def main():\n"
     "    x = torch.ones(4).cuda()\n"
     "    maybe_arm('gpu')\n"
     "    torch.cuda.synchronize()\n",
     [3],
     "import torch\n"
     "def main():\n"
     "    if not torch.cuda.is_available():\n"
     "        return 1\n"
     "    dev = device.resolve('gpu')\n"
     "    maybe_arm('gpu')\n"
     "    x = torch.ones(4).to(dev)\n"
     "    _cuda.build()\n"),
    ("RED012", "utils/emitter.py",
     "def bad(ledger, rid):\n"
     '    print(\'{"t": 1, "ev": "x.y", "pid": 2}\')\n'
     "    ledger.emit('serve.launch', trace=rid)\n"
     "    print(f'compiled in {rid:.2f}s')\n",
     [2, 3, 4],
     "def good(ledger):\n"
     "    ledger.emit('serve.launch', n=4)\n"
     "    print('first compile takes a while')\n"),
    ("RED013", "bench/plan.py",
     "BUDGET_S = 600\n"
     "task = dict(name='x', budget_s=60)\n",
     [1, 2],
     "from tpu_reductions_torch.sched.tasks import get_task\n"
     "task = get_task('smoke')\n"
     "budget = task.budget_s\n"),
    ("RED014", "serve/engine_part.py",
     "import torch\n"
     "def go(x, dev, dist):\n"
     "    y = x.cuda()\n"
     "    torch.cuda.synchronize()\n"
     "    _cuda.k6_reduce(x, y, y, None)\n"
     "    return run_benchmark(y)\n",
     [3, 4, 5, 6],
     "import torch\n"
     "def go(executor, device_mod):\n"
     "    dev = device_mod.resolve('gpu')\n"
     "    if torch.cuda.is_available():\n"
     "        return executor.run_batch('SUM', 'int32', 8, [0])\n"),
    ("RED015", "ops/ingest.py",
     "import torch\n"
     "def put(x, device, mesh):\n"
     "    a = x.to(device)\n"
     "    b = x.cuda()\n"
     "    c = torch.as_tensor(x, device=mesh.device)\n"
     "    return a, b, c\n",
     [3, 4, 5],
     "import torch\n"
     "def cast(x, acc, dev):\n"
     "    a = x.to(torch.float32)\n"
     "    b = x.to(acc.dtype)\n"
     "    c = torch.zeros(4, device=dev)\n"
     "    return a, b, c\n"),
    ("RED016", "bench/hops.py",
     "import torch.distributed as dist\n"
     "from torch.distributed import all_gather\n"
     "def hop(t, mesh):\n"
     "    dist.all_reduce(t)\n"
     "    return ring_rs_ag(mesh, 4, (t,), None, None)\n",
     [2, 4, 5],
     "import torch.distributed as dist\n"
     "def group(sock, t):\n"
     "    dist.init_process_group('gloo')\n"
     "    dist.get_rank()\n"
     "    dist.barrier()\n"
     "    sock.send(b'x')\n"
     "    return sock.recv(4)\n"),
    ("RED025", "bench/wired.py",
     "from tpu_reductions_torch.utils import heartbeat\n"
     "from tpu_reductions_torch.utils.retry import retry_device_call\n"
     "def run(fn):\n"
     "    with heartbeat.guard('x'):\n"
     "        return retry_device_call(fn)\n",
     [2, 4, 5],
     "def build(ctx, fn):\n"
     "    with ctx.guard('x'):\n"
     "        ctx.tick()\n"
     "        return ctx.call(fn)\n"),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_rule_fires_on_violation(tmp_path, case):
    rule, path, bad, lines, _ = case
    assert _lines(_lint(tmp_path, bad, path), rule) == lines


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_rule_quiet_on_clean_spelling(tmp_path, case):
    rule, path, _, _, good = case
    assert rule not in _rules(_lint(tmp_path, good, path))


# the homes: the same violating source, linted at the rule's home, is clean
HOMES = [("RED002", "utils/timing.py", 0), ("RED005", "lint/grammar.py", 2),
         ("RED010", "utils/jsonio.py", 4), ("RED012", "obs/ledger.py", 7),
         ("RED013", "sched/tasks.py", 8), ("RED014", "serve/executor.py", 9),
         ("RED015", "utils/staging.py", 10), ("RED015", "ops/stream.py", 10),
         ("RED016", "collectives/rings.py", 11),
         ("RED016", "reshard/primitives.py", 11),
         ("RED025", "exec/core.py", 12)]


@pytest.mark.parametrize("rule,home,i", HOMES,
                         ids=[f"{r}-{h}" for r, h, _ in HOMES])
def test_rule_home_is_exempt(tmp_path, rule, home, i):
    assert CASES[i][0] == rule
    assert rule not in _rules(_lint(tmp_path, CASES[i][2], home))


def test_scope_dirs_bound_the_scoped_rules(tmp_path):
    """RED011 reads bench/ mains only, RED014 serve/ only, RED015 the
    measured packages only, RED006 ops/ and bench/ only."""
    assert "RED011" not in _rules(_lint(tmp_path, CASES[6][2],
                                        "sched/entry.py"))
    assert "RED014" not in _rules(_lint(tmp_path, CASES[9][2],
                                        "obs/engine_part.py"))
    assert "RED015" not in _rules(_lint(tmp_path, CASES[10][2],
                                        "obs/ingest.py"))
    assert "RED006" not in _rules(_lint(tmp_path, CASES[3][2],
                                        "serve/thing.py"))


@pytest.mark.parametrize("src", [
    "import jax\n"
    "import jax.numpy as jnp\n"
    'jax.config.update("jax_enable_x64", True)\n'
    "y = jnp.zeros(4, dtype=jnp.float64)\n"
    "z = torch.zeros(4, dtype=torch.float64)\n",
    "import os\nos.environ['JAX_PLATFORMS'] = 'cpu'\n",
    "import sys\nimport torch\ndef main():\n    sys.exit(1)\n",
    "import jax\ndef stage(x):\n    return jax.device_put(x)\n",
], ids=["RED001", "RED004", "RED007", "RED003"])
def test_rules_that_do_not_carry_stay_quiet(tmp_path, src):
    """RED001 (native f64 on the card), RED004 (--platform), RED007 (a
    card's context ends with its process) and RED003 (folded into
    RED015's torch spelling) fire nothing in the port."""
    found = _rules(_lint(tmp_path, src, "ops/x.py"))
    assert not {"RED001", "RED003", "RED004", "RED007"} & set(found)


def test_shell_scripts_are_not_read(tmp_path):
    (tmp_path / "s.sh").write_text("kill -9 $PID\n")
    assert lint_paths([tmp_path], flow=False) == []


# ------------------------------------------------------------- grammar


def test_grammar_templates_are_the_producers():
    from tpu_reductions_torch.obs import ledger
    from tpu_reductions_torch.utils import logging as log, qa
    assert qa.QA_FINISH_TEMPLATE is grammar.QA_FINISH_TEMPLATE
    assert qa.QA_RUNNING_TEMPLATE is grammar.QA_RUNNING_TEMPLATE
    assert log.THROUGHPUT_TEMPLATE is grammar.THROUGHPUT_TEMPLATE
    assert log.COLLECTIVE_HEADER is grammar.COLLECTIVE_HEADER
    assert log.FAMILY_ROW_TEMPLATE is grammar.FAMILY_ROW_TEMPLATE
    assert log.QUANT_CURVE_ROW_TEMPLATE is grammar.QUANT_CURVE_ROW_TEMPLATE
    assert ledger.EVENT_NAME_RE is grammar.EVENT_NAME_RE
    row = log.throughput_line(1.5, 0.25, 1 << 20)
    assert grammar.THROUGHPUT_RE.match(row)
    assert grammar.check_literal(row) is None


@pytest.mark.parametrize("text,ok", [
    ("&&&& RUNNING tpu_reductions_torch --n=4", True),
    ("&&&& tpu_reductions_torch PASSED", True),
    ("&&&& tpu_reductions_torch DONE", False),
    ("DATATYPE OP NODES GB/sec", True),
    ("DATATYPE OP GB/sec", False),
    ("Reduction, Throughput = ", True),
    ("Reduction, Throughput = 1.0 GB/s, Time = 2 s", False),
])
def test_check_literal(text, ok):
    assert (grammar.check_literal(text) is None) == ok


def test_importing_qa_loads_no_engine():
    code = ("import sys, tpu_reductions_torch.utils.qa, "
            "tpu_reductions_torch.utils.logging, "
            "tpu_reductions_torch.obs.ledger\n"
            "lint = sorted(m for m in sys.modules "
            "if m.startswith('tpu_reductions_torch.lint'))\n"
            "assert lint == ['tpu_reductions_torch.lint', "
            "'tpu_reductions_torch.lint.grammar'], lint\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------- waivers


BAD_DUMP = "import json\ndef save(rows, f):\n    json.dump(rows, f)\n"


def test_trailing_waiver_suppresses(tmp_path):
    src = BAD_DUMP.replace(
        "json.dump(rows, f)\n",
        "json.dump(rows, f)  # redlint: disable=RED010 -- a test pipe\n")
    assert _lint(tmp_path, src) == []


def test_standalone_waiver_guards_the_next_line(tmp_path):
    src = BAD_DUMP.replace(
        "    json.dump(rows, f)\n",
        "    # redlint: disable=RED010 -- a test pipe\n"
        "    json.dump(rows, f)\n")
    assert _lint(tmp_path, src) == []


def test_standalone_waiver_reaches_past_decorators(tmp_path):
    src = ('"""Module (reduction.cpp:1)."""\n'
           "import functools\n"
           "# redlint: disable=RED006 -- a test fixture\n"
           "@functools.lru_cache\n"
           "def public():\n"
           "    pass\n")
    assert _lint(tmp_path, src, "ops/deco.py") == []


def test_waiver_without_reason_is_red000(tmp_path):
    src = BAD_DUMP.replace("json.dump(rows, f)\n",
                           "json.dump(rows, f)  # redlint: disable=RED010\n")
    assert sorted(_rules(_lint(tmp_path, src))) == ["RED000", "RED010"]


def test_stale_waiver_is_red009(tmp_path):
    src = "def f():\n    return 1  # redlint: disable=RED010 -- nothing\n"
    found = _lint(tmp_path, src)
    assert _rules(found) == ["RED009"] and found[0].line == 2


def test_waiver_text_inside_a_string_does_not_arm(tmp_path):
    src = ('MSG = "# redlint: disable=RED010 -- written in a string"\n'
           "import json\n"
           "def save(rows, f):\n"
           '    """# redlint: disable=RED010 -- in a docstring"""\n'
           "    json.dump(rows, f)\n")
    found = _lint(tmp_path, src)
    assert _rules(found) == ["RED010"] and found[0].line == 5


def test_flow_waiver_not_judged_stale_without_flow(tmp_path):
    src = "def f():\n    return 1  # redlint: disable=RED017 -- entry\n"
    assert _lint(tmp_path, src) == []
    f = tmp_path / "w.py"
    f.write_text(src)
    assert _rules(lint_paths([f], flow=True, flow_cache=None)) == ["RED009"]


# -------------------------------------------------------------- fixers


def test_fix_docstrings_marks_port_native(tmp_path):
    f = tmp_path / "ops" / "x.py"
    f.parent.mkdir()
    f.write_text('"""Module."""\n'
                 "def public():\n"
                 '    """Does a thing."""\n')
    fixed = fix_docstrings([tmp_path])
    assert sorted(name for _, _, name in fixed) == ["<module>", "public"]
    text = f.read_text()
    assert MARKER == "No reference analog (port-native)." and \
        text.count(MARKER) == 2 and "TPU" not in text
    assert fix_docstrings([tmp_path]) == []
    assert lint_paths([tmp_path], flow=False) == []


def test_fix_stale_waivers_removes_them(tmp_path):
    f = tmp_path / "w.py"
    f.write_text("# redlint: disable=RED010 -- stale\n"
                 "x = 1\n"
                 "y = 2  # redlint: disable=RED013 -- stale too\n")
    removed = fix_stale_waivers([f], flow=False)
    assert [(line, rules) for _, line, rules in removed] == \
        [(3, "RED013"), (1, "RED010")]
    assert f.read_text() == "x = 1\ny = 2\n"
    assert fix_stale_waivers([f], flow=False) == []


# ----------------------------------------------------------------- CLI


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.lint", *args,
         "--flow-cache="], capture_output=True, text=True, cwd=REPO,
        timeout=120)


def test_cli_exit_codes_and_json(tmp_path):
    (tmp_path / "clean.py").write_text("x = 1\n")
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "b.py").write_text(BAD_DUMP)
    ok = _cli(str(tmp_path / "clean.py"))
    assert ok.returncode == 0 and "clean" in ok.stdout
    found = _cli(str(bad), "--format=json")
    assert found.returncode == 1
    rows = json.loads(found.stdout)
    assert [sorted(r) for r in rows] == [["line", "message", "path",
                                          "rule"]]
    assert rows[0]["rule"] == "RED010" and rows[0]["line"] == 3
    assert _cli("--format=xml").returncode == 2
    assert _cli(str(tmp_path / "missing")).returncode == 2


# ------------------------------------------- the stager RED015 points to


@pytest.mark.parametrize("shape,dtype", [((1000,), "int32"),
                                         ((4, 300), "int64"),
                                         ((1, 777), "bool")])
def test_stage_flat_gives_the_tensor_back_in_its_shape(monkeypatch, shape,
                                                       dtype):
    """Above the threshold stage_flat goes through device_put_chunked (in
    chunks of 64 bytes here, on the CPU standing in for the card) and
    gives the payload back bit for bit, in its shape and dtype."""
    import torch

    from tpu_reductions_torch.utils import staging
    real = staging.maybe_chunked_stage
    seen = []

    def chunked(flat, rows, lanes, identity, device):
        seen.append((rows, lanes))
        return staging.device_put_chunked(flat, rows, lanes, identity,
                                          torch.device("cpu"),
                                          chunk_bytes=64)
    x = (torch.arange(int(np.prod(shape))) % 7 > 2) if dtype == "bool" \
        else torch.arange(int(np.prod(shape)), dtype=getattr(torch, dtype))
    x = x.reshape(shape)
    monkeypatch.setattr(staging, "maybe_chunked_stage", chunked)
    got = staging.stage_flat(x, torch.device("meta"))
    assert seen == [(-(-x.numel() // 128), 128)]
    assert got.shape == x.shape and got.dtype == x.dtype
    assert torch.equal(got, x)
    monkeypatch.setattr(staging, "maybe_chunked_stage", real)
    assert torch.equal(staging.stage_flat(x, torch.device("cpu")), x)
