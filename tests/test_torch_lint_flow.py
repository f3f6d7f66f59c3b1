"""The port lint's whole-program layers: the flow rules RED017-RED020 on
torch fixtures, the concurrency rules RED021-RED024, the seeded-defect
probes on copies of the port's own sources, the fact cache (judged by
counting extractions, never by the clock), the graph export, and a
property test of the call graph's alias resolution.

Fixture trees live under a `proj/` package dir, so absolute imports
(`from proj.work import helper`) resolve against the scan root as the
real scan resolves `tpu_reductions_torch.*` from the repo root.
"""

import json
import random
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_reductions_torch.lint.conc import extract as conc_extract
from tpu_reductions_torch.lint.engine import (FLOW_RULES, iter_lintable,
                                              lint_paths)
from tpu_reductions_torch.lint.flow import dataflow
from tpu_reductions_torch.lint.flow import facts as F
from tpu_reductions_torch.lint.flow.callgraph import (Project,
                                                      extract_module,
                                                      module_name_for)
from tpu_reductions_torch.lint.flow.dataflow import (analyze_flow,
                                                     build_cached_project,
                                                     export_graph)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tpu_reductions_torch"


def _tree(tmp_path, files, pkg="proj"):
    root = tmp_path / pkg
    for rel, src in files.items():
        f = root / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(src)
    return root


def _flow(root, cache=None):
    files = sorted(root.rglob("*.py"))
    return analyze_flow(files, [root], rels={f: str(f) for f in files},
                        cache_path=cache)


def _flat(raws, rules=None):
    return sorted((Path(rel).name, f.rule, f.line)
                  for rel, lst in raws.items() for f in lst
                  if rules is None or f.rule in rules)


def _messages(raws, rule):
    return [f.message for lst in raws.values() for f in lst
            if f.rule == rule]


CLI = ("from proj.work import helper\n"
       "\n"
       "def main():\n"
       "    helper()\n"
       "\n"
       "if __name__ == \"__main__\":\n"
       "    main()\n")

GATED_CLI = CLI.replace(
    "def main():\n",
    "def main():\n"
    "    from proj.exec.core import maybe_arm\n"
    "    maybe_arm('gpu')\n")

# a device touch two frames below the entry: a synchronize, unguarded
DEVICE_WORK = ("import torch\n"
               "\n"
               "def helper():\n"
               "    return deeper()\n"
               "\n"
               "def deeper():\n"
               "    torch.cuda.synchronize()\n")


# ---------------------------------------------------------------- RED017


def test_red017_fires_through_helper_frames(tmp_path):
    root = _tree(tmp_path, {"cli.py": CLI, "work.py": DEVICE_WORK})
    raws = _flow(root)
    assert ("cli.py", "RED017", 7) in _flat(raws)
    msg = _messages(raws, "RED017")[0]
    assert "proj.work.helper -> proj.work.deeper" in msg


def test_red017_quiet_when_gated(tmp_path):
    root = _tree(tmp_path, {"cli.py": GATED_CLI, "work.py": DEVICE_WORK})
    assert "RED017" not in [r for _, r, _ in _flat(_flow(root))]


def test_red017_gate_inside_an_earlier_callee_counts(tmp_path):
    cli = CLI.replace("def main():\n    helper()\n",
                      "def arm():\n"
                      "    from proj.utils.preflight import gate_verdict\n"
                      "    gate_verdict()\n"
                      "\n"
                      "def main():\n"
                      "    arm()\n"
                      "    helper()\n")
    root = _tree(tmp_path, {"cli.py": cli, "work.py": DEVICE_WORK})
    assert "RED017" not in [r for _, r, _ in _flat(_flow(root))]


@pytest.mark.parametrize("query", [
    "torch.cuda.is_available()", "torch.cuda.device_count()",
    "torch.cuda.get_device_name(0)", "device.resolve('gpu')"])
def test_backend_queries_are_not_touches(tmp_path, query):
    work = ("import torch\n"
            "from proj import device\n"
            "\n"
            "def helper():\n"
            f"    return {query}\n")
    root = _tree(tmp_path, {"cli.py": CLI, "work.py": work,
                            "device.py": "def resolve(p):\n    pass\n"})
    assert _flat(_flow(root)) == []


@pytest.mark.parametrize("touch,dispatch", [
    ("torch.cuda.synchronize()", True),
    ("x.to(dev)", True),
    ("x.cuda()", True),
    ("torch.tensor([1], device=dev)", True),
    ("_cuda.k8_reduce(x, x, x, None)", True),
    ("entry.graph.replay()", True),
    ("dist.all_reduce(x)", True),
    ("torch.cuda.Stream(dev)", False),
    ("torch.zeros(4, device=dev)", False),
    ("_cuda.build()", False),
    ("torch.cuda.set_device(0)", False),
])
def test_touch_and_dispatch_seeds(tmp_path, touch, dispatch):
    """Each spelling touches the card (RED017); those that queue or wait
    for work are DISPATCH too (RED019)."""
    work = ("import torch\n"
            "import torch.distributed as dist\n"
            "from proj.ops import _cuda\n"
            "\n"
            "def helper(x=None, dev=None, entry=None):\n"
            f"    return {touch}\n")
    root = _tree(tmp_path, {"cli.py": CLI, "work.py": work,
                            "ops/_cuda.py": "def build():\n    pass\n"})
    rules = [r for _, r, _ in _flat(_flow(root))]
    assert "RED017" in rules
    assert ("RED019" in rules) == dispatch


def test_a_dtype_cast_is_not_a_touch(tmp_path):
    work = ("import torch\n"
            "\n"
            "def helper(x, acc):\n"
            "    return x.to(torch.float32), x.to(acc.dtype)\n")
    root = _tree(tmp_path, {"cli.py": CLI, "work.py": work})
    assert _flat(_flow(root)) == []


# ---------------------------------------------------------------- RED019


def test_red019_fires_on_unguarded_dispatch(tmp_path):
    root = _tree(tmp_path, {"cli.py": GATED_CLI, "work.py": DEVICE_WORK})
    assert _flat(_flow(root)) == [("cli.py", "RED019", 9)]


@pytest.mark.parametrize("wrap", [
    "    from proj.exec import core as exec_core\n"
    "    exec_core.run(None)\n",
    "    from proj.utils import heartbeat\n"
    "    heartbeat.tick()\n",
    "    from proj.utils.retry import retry_device_call\n"
    "    retry_device_call(None)\n",
])
def test_red019_quiet_under_guard_or_retry(tmp_path, wrap):
    work = DEVICE_WORK.replace("def helper():\n",
                               "def helper():\n" + wrap)
    root = _tree(tmp_path, {"cli.py": GATED_CLI, "work.py": work})
    assert _flat(_flow(root)) == []


# ---------------------------------------------------------------- RED018


TIMED = ("import time\n"
         "from proj.work import helper\n"
         "\n"
         "def bench():\n"
         "    t0 = time.perf_counter()\n"
         "    helper()\n"
         "    return time.perf_counter() - t0\n")


def test_red018_fires_on_a_syncing_callee_in_a_window(tmp_path):
    root = _tree(tmp_path, {"timed.py": TIMED, "work.py": DEVICE_WORK})
    assert _flat(_flow(root)) == [("timed.py", "RED018", 6)]


def test_red018_quiet_when_the_callee_does_not_sync(tmp_path):
    work = "def helper():\n    return 1\n"
    root = _tree(tmp_path, {"timed.py": TIMED, "work.py": work})
    assert _flat(_flow(root)) == []


def test_red018_quiet_in_the_timing_homes(tmp_path):
    root = _tree(tmp_path, {"utils/timing.py": TIMED,
                            "work.py": DEVICE_WORK})
    assert _flat(_flow(root)) == []


@pytest.mark.parametrize("call", ["x.item()", "x.cpu()", "x.tolist()"])
def test_host_reads_do_not_seed_sync(tmp_path, call):
    """.item()/.cpu()/.tolist() do not seed SYNC: their spelling cannot
    tell a card tensor from a CPU one (docs/PORT.md)."""
    work = f"def helper(x=None):\n    return {call}\n"
    root = _tree(tmp_path, {"timed.py": TIMED, "work.py": work})
    assert _flat(_flow(root)) == []


# ---------------------------------------------------------------- RED020


INGEST_CLI = ("from torch import as_tensor as put\n"
              "\n"
              "def main(x, dev):\n"
              "    return put(x, device=dev)\n"
              "\n"
              "if __name__ == \"__main__\":\n"
              "    main(None, None)\n")


def test_red020_fires_on_an_aliased_ingest(tmp_path):
    root = _tree(tmp_path, {"cli.py": INGEST_CLI})
    assert ("cli.py", "RED020", 4) in _flat(_flow(root))


def test_red020_quiet_behind_a_staging_node(tmp_path):
    cli = INGEST_CLI.replace(
        "    return put(x, device=dev)\n",
        "    from proj.utils.staging import maybe_chunked_stage\n"
        "    maybe_chunked_stage(x, 1, 128, 0, dev)\n"
        "    return put(x, device=dev)\n")
    root = _tree(tmp_path, {"cli.py": cli})
    assert "RED020" not in [r for _, r, _ in _flat(_flow(root))]


def test_red020_defers_to_red015_in_its_scope_dirs(tmp_path):
    root = _tree(tmp_path, {"bench/cli.py": INGEST_CLI})
    flat = _flat(_flow(root))
    assert "RED020" not in [r for _, r, _ in flat]


# ------------------------------------------------------- conc fixtures


RACY = ("import threading\n"
        "\n"
        "_count = 0\n"
        "_lock = threading.Lock()\n"
        "\n"
        "def worker():\n"
        "    global _count\n"
        "    _count = _count + 1\n"
        "\n"
        "def main():\n"
        "    global _count\n"
        "    t = threading.Thread(target=worker, daemon=True)\n"
        "    t.start()\n"
        "    _count = _count + 1\n"
        "\n"
        "if __name__ == \"__main__\":\n"
        "    main()\n")

INVERTED = ("import threading\n"
            "\n"
            "a = threading.Lock()\n"
            "b = threading.Lock()\n"
            "\n"
            "def one():\n"
            "    with a:\n"
            "        with b:\n"
            "            pass\n"
            "\n"
            "def two():\n"
            "    with b:\n"
            "        with a:\n"
            "            pass\n"
            "\n"
            "def main():\n"
            "    threading.Thread(target=one, daemon=True).start()\n"
            "    two()\n"
            "\n"
            "if __name__ == \"__main__\":\n"
            "    main()\n")

BLOCKING = ("import threading\n"
            "\n"
            "_lock = threading.Lock()\n"
            "\n"
            "def worker(sock):\n"
            "    with _lock:\n"
            "        sock.recv(4096)\n"
            "\n"
            "def main():\n"
            "    threading.Thread(target=worker, daemon=True).start()\n"
            "\n"
            "if __name__ == \"__main__\":\n"
            "    main()\n")

LEAKED = ("import threading\n"
          "\n"
          "def worker():\n"
          "    pass\n"
          "\n"
          "def main():\n"
          "    t = threading.Thread(target=worker)\n"
          "    t.start()\n"
          "\n"
          "if __name__ == \"__main__\":\n"
          "    main()\n")

CONC_CASES = [
    ("RED021", RACY, ("    _count = _count + 1\n" * 2,),
     lambda s: s.replace("    _count = _count + 1\n",
                         "    with _lock:\n        _count = _count + 1\n")),
    ("RED022", INVERTED, (),
     lambda s: s.replace("    with b:\n        with a:\n",
                         "    with a:\n        with b:\n")),
    ("RED023", BLOCKING, (),
     lambda s: s.replace("sock.recv(4096)", "pass\n    sock.recv(4096)")),
    ("RED024", LEAKED, (),
     lambda s: s.replace("    t.start()\n", "    t.start()\n    t.join()\n")),
]


@pytest.mark.parametrize("rule,src,_unused,fix", CONC_CASES,
                         ids=[c[0] for c in CONC_CASES])
def test_conc_rule_fires_and_its_fix_is_quiet(tmp_path, rule, src,
                                              _unused, fix):
    root = _tree(tmp_path, {"app.py": src})
    assert rule in [r for _, r, _ in _flat(_flow(root))]
    (root / "app.py").write_text(fix(src))
    assert rule not in [r for _, r, _ in _flat(_flow(root))]


def test_device_sync_under_a_lock_is_red023(tmp_path):
    src = BLOCKING.replace("sock.recv(4096)", "sock.synchronize()")
    root = _tree(tmp_path, {"app.py": src})
    msgs = _messages(_flow(root), "RED023")
    assert msgs and "synchronize" in msgs[0]


def test_conc_waiver_suppresses_and_goes_stale(tmp_path):
    waived = RACY.replace(
        "def worker():\n    global _count\n    _count = _count + 1\n",
        "def worker():\n    global _count\n"
        "    # redlint: disable=RED021 -- a test-serialized caller\n"
        "    _count = _count + 1\n")
    root = _tree(tmp_path, {"app.py": waived})
    assert [f for f in lint_paths([root])
            if f.rule in FLOW_RULES + ("RED009",)] == []
    guarded = waived.replace("    _count = _count + 1\n",
                             "    with _lock:\n        _count = _count + 1\n")
    (root / "app.py").write_text(guarded)
    assert [f.rule for f in lint_paths([root])] == ["RED009"]
    assert lint_paths([root], flow=False) == []


# ------------------------------------- seeded defects, the port's sources


def _copy(tmp_path, rels, edit=None):
    root = tmp_path / "tpu_reductions_torch"
    for rel in rels:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        src = (PORT / rel).read_text()
        dst.write_text(edit(rel, src) if edit else src)
    return root


def test_deleting_the_gate_from_spot_fires_red017(tmp_path):
    """Drop maybe_arm from bench/spot.py's main and RED017 fires through
    the helper frames main -> run_spots -> run_benchmark; with the gate
    the copy is clean."""
    rels = ("bench/spot.py", "bench/driver.py")
    assert _flow(_copy(tmp_path / "a", rels)) == {}
    gate = "    maybe_arm(ns.platform)\n"

    def drop(rel, src):
        if rel != "bench/spot.py":
            return src
        assert src.count(gate) == 1
        return src.replace(gate, "    disabled_gate_probe(ns.platform)\n")
    raws = _flow(_copy(tmp_path / "b", rels, drop))
    assert [(name, rule) for name, rule, _ in _flat(raws)] == \
        [("spot.py", "RED017")]
    msg = _messages(raws, "RED017")[0]
    assert "spot.run_spots -> " in msg and "driver.run_benchmark" in msg


def _reaches_k6(project, fqn):
    """Whether `fqn` calls the k6 launch wrapper (_cuda.k6_reduce, a
    DISPATCH site) itself or over resolved edges."""
    seen, todo = set(), [fqn]
    while todo:
        at = todo.pop()
        if at in seen:
            continue
        seen.add(at)
        for cs in project.nodes[at][1].calls:
            if cs.raw.endswith("_cuda.k6_reduce") and \
                    F.DISPATCH in F.classify_call(cs):
                return True
            callee = project.resolve_target(cs.target) if cs.target \
                else None
            if callee:
                todo.append(callee)
    return False


@pytest.mark.parametrize("where", ["single_pass_call", "K6Binding.call",
                                   "StagedK6.call", "_device_fn",
                                   "make_staged_reduce", "kernel_reduce"])
def test_the_bound_k6_launch_stays_dispatch_on_the_main_path(tmp_path,
                                                             where):
    """k6's launch, bound or not, goes through the kernel wrapper the flow
    rules know, so single_pass_call, the bound launch and
    make_staged_reduce (its reduce_fn folds into it) reach k6's DISPATCH
    over edges the call graph resolves; a launch spelled any other way
    reaches nothing."""
    rels = ("ops/kernel_reduce.py", "ops/_cuda.py")
    mod = "tpu_reductions_torch.ops.kernel_reduce::"

    def project_of(root):
        files = sorted(root.rglob("*.py"))
        return build_cached_project(files, [root],
                                    rels={f: str(f) for f in files})

    project = project_of(_copy(tmp_path / "a", rels))
    assert _reaches_k6(project, mod + where)
    summary = dataflow.compute_summaries(project)[mod + where]
    assert summary.unguarded_dispatch is not None

    def hide(rel, src):
        return src.replace("_cuda.k6_reduce(", "_cuda.k6_launch_probe(") \
            if rel == "ops/kernel_reduce.py" else src
    hidden = project_of(_copy(tmp_path / "b", rels, hide))
    assert not _reaches_k6(hidden, mod + where)


ENGINE_DRIVER = ("from tpu_reductions_torch.serve.engine import ServeEngine\n"
                 "\n"
                 "def main():\n"
                 "    eng = ServeEngine()\n"
                 "    eng.start()\n"
                 "    eng.submit(None)\n"
                 "    eng.stop()\n"
                 "\n"
                 "if __name__ == \"__main__\":\n"
                 "    main()\n")

# ServeEngine._bump as committed; the seeds below edit exactly this text
GUARDED_BUMP = ("        with self._stats_lock:\n"
                "            self.stats[key] = self.stats.get(key, 0) "
                "+ delta\n")


def _engine(tmp_path, edit=None):
    def seed(rel, src):
        if rel == "serve/engine.py" and edit:
            assert src.count(GUARDED_BUMP) == 1
            return edit(src)
        return src
    root = _copy(tmp_path, ("serve/engine.py",), seed)
    (root / "cli.py").write_text(ENGINE_DRIVER)
    return _flow(root)


CONC = ("RED021", "RED022", "RED023", "RED024")


def test_the_engine_copy_is_conc_clean(tmp_path):
    assert _flat(_engine(tmp_path), CONC) == []


def test_stats_bump_out_of_its_lock_fires_red021(tmp_path):
    raws = _engine(tmp_path, lambda s: s.replace(
        GUARDED_BUMP,
        "        self.stats[key] = self.stats.get(key, 0) + delta\n"))
    msgs = _messages(raws, "RED021")
    assert any("ServeEngine.stats" in m for m in msgs), msgs
    assert any("->" in m for m in msgs)


def test_recv_under_the_stats_lock_fires_red023(tmp_path):
    raws = _engine(tmp_path, lambda s: s.replace(
        GUARDED_BUMP, GUARDED_BUMP + "            "
        "self._transport.sock.recv(4096)\n"))
    flat = _flat(raws, CONC)
    assert [r for _, r, _ in flat] == ["RED023"], flat


# ------------------------------------------------------ cache, by count


@pytest.fixture
def counted(monkeypatch):
    """Counts the per-file extractions build_cached_project makes."""
    n = {"flow": 0, "conc": 0}
    real_flow, real_conc = dataflow.extract_module, conc_extract.extract_conc

    def flow(*a, **k):
        n["flow"] += 1
        return real_flow(*a, **k)

    def conc(*a, **k):
        n["conc"] += 1
        return real_conc(*a, **k)
    monkeypatch.setattr(dataflow, "extract_module", flow)
    monkeypatch.setattr(dataflow.C, "extract_conc", conc)
    return n


def test_warm_pass_reparses_no_unchanged_file(tmp_path, counted):
    root = _tree(tmp_path, {"cli.py": CLI, "work.py": DEVICE_WORK,
                            "app.py": RACY})
    cache = tmp_path / "cache.json"
    cold = _flat(_flow(root, cache))
    assert counted == {"flow": 3, "conc": 3}
    stamp = cache.stat().st_mtime_ns
    assert _flat(_flow(root, cache)) == cold
    assert counted == {"flow": 3, "conc": 3}
    assert cache.stat().st_mtime_ns == stamp       # nothing rewritten
    (root / "cli.py").write_text(GATED_CLI)
    assert "RED017" not in [r for _, r, _ in _flat(_flow(root, cache))]
    assert counted == {"flow": 4, "conc": 4}


def test_editing_a_lint_source_busts_every_entry(tmp_path, counted,
                                                 monkeypatch):
    root = _tree(tmp_path, {"cli.py": CLI, "work.py": DEVICE_WORK})
    cache = tmp_path / "cache.json"
    _flow(root, cache)
    assert counted["flow"] == 2
    # the stamp's last part digests every .py of the lint package: an
    # edited copy of the package digests differently...
    lint = tmp_path / "lint"
    for f in (PORT / "lint").rglob("*.py"):
        dst = lint / f.relative_to(PORT / "lint")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(f.read_text())
    before = dataflow.fingerprint_of(lint)
    assert before == dataflow.schema_fingerprint()
    rules = lint / "rules.py"
    rules.write_text(rules.read_text() + "\n# an edit\n")
    after = dataflow.fingerprint_of(lint)
    assert after != before
    # ...and a stamp that differs re-extracts every file
    monkeypatch.setattr(dataflow, "_FINGERPRINT", after)
    _flow(root, cache)
    assert counted["flow"] == 4
    assert json.loads(cache.read_text())["version"][-1] == after


def test_a_corrupt_cache_is_ignored(tmp_path):
    root = _tree(tmp_path, {"cli.py": CLI, "work.py": DEVICE_WORK})
    cache = tmp_path / "cache.json"
    cache.write_text("{not json")
    assert [r for _, r, _ in _flat(_flow(root, cache))] == \
        ["RED017", "RED019"]


def test_the_cli_cache_is_not_the_jax_lints():
    from tpu_reductions_torch.lint import __main__ as cli
    import inspect
    assert '".lint_cache_torch.json"' in inspect.getsource(cli.main)
    assert ".lint_cache_torch.json" in (REPO / ".gitignore").read_text()


# ---------------------------------------------------------------- graph


def test_graph_export_json_and_dot(tmp_path):
    root = _tree(tmp_path, {"cli.py": CLI, "work.py": DEVICE_WORK,
                            "app.py": RACY})
    files = sorted(root.rglob("*.py"))
    project = build_cached_project(files, [root],
                                   rels={f: str(f) for f in files})
    g = json.loads(export_graph(project, "json"))
    deeper = next(n for n in g["functions"] if n["id"] == "proj.work::deeper")
    assert {"TOUCHES_DEVICE", "DISPATCH", "SYNC"} <= set(deeper["facts"])
    assert ("proj.cli::main", "proj.work::helper") in \
        {(e["from"], e["to"]) for e in g["edges"]}
    assert g["thread_roots"] == ["proj.app::worker"]
    assert g["locks"] == ["proj.app._lock"]
    dot = export_graph(project, "dot")
    assert dot.startswith("digraph") and "peripheries=2" in dot


def test_module_names_from_the_port_root():
    assert module_name_for(PORT / "bench" / "spot.py", [PORT]) == \
        "tpu_reductions_torch.bench.spot"
    assert module_name_for(PORT / "lint" / "__init__.py", [PORT]) == \
        "tpu_reductions_torch.lint"
    assert module_name_for(REPO / "chip_smoke.py",
                           [PORT, REPO / "chip_smoke.py"]) == "chip_smoke"


def test_the_conc_layer_ran_on_the_port(tmp_path):
    """ServeEngine._run is a thread root and ledger._state_lock a lock,
    on a cold build and through the cache (a cache entry missing its
    conc facts would switch RED021-RED024 off and fail nothing else)."""
    targets = [PORT, REPO / "chip_smoke.py"]
    py = iter_lintable(targets)
    cache = tmp_path / "cache.json"
    for attempt in ("cold", "warm"):
        project = build_cached_project(
            py, targets, rels={f: str(f) for f in py}, cache_path=cache)
        out = json.loads(export_graph(project, "json"))
        assert any(r.endswith("serve.engine::ServeEngine._run")
                   for r in out["thread_roots"]), attempt
        assert any(lk.endswith("obs.ledger._state_lock")
                   for lk in out["locks"]), attempt
        assert out["spawn_edges"], attempt


# ------------------------------------------------ alias resolution, a property

LIB = "proj.lib"
FNS = [f"fn_{i}" for i in range(6)]
# (import line, call): `{fn}` a function of proj.lib, `{alias}` a local name
STYLES = [
    ("import proj.lib", "proj.lib.{fn}()"),
    ("import proj.lib as {alias}", "{alias}.{fn}()"),
    ("from proj import lib", "lib.{fn}()"),
    ("from proj import lib as {alias}", "{alias}.{fn}()"),
    ("from proj.lib import {fn}", "{fn}()"),
    ("from proj.lib import {fn} as {alias}", "{alias}()"),
    ("from .lib import {fn}", "{fn}()"),
]
LIB_SRC = "".join(f"def {fn}():\n    pass\n\n" for fn in FNS) + (
    "class Widget:\n    def __init__(self):\n        pass\n")


def _resolve_entry(src):
    mods = {LIB: extract_module(LIB_SRC, LIB, "proj/lib.py"),
            "proj.app": extract_module(src, "proj.app", "proj/app.py")}
    assert not mods["proj.app"].parse_error
    project = Project(mods)
    entry = mods["proj.app"].functions["entry"]
    return [project.resolve_target(c.target) for c in entry.calls]


_alias = st.from_regex(r"[a-z]{1,6}_[0-9]{1,3}", fullmatch=True)
_pick = st.tuples(st.integers(0, len(STYLES) - 1),
                  st.integers(0, len(FNS) - 1), _alias)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(_pick, min_size=1, max_size=4))
def test_every_alias_style_resolves_to_its_definition(picks):
    """Any mix of alias styles, the last binding of a name winning as in
    Python, resolves every call to the function it names."""
    lines, calls, bound = [], [], {}
    for j, (si, fi, alias) in enumerate(picks):
        imp, call = STYLES[si]
        alias = f"{alias}{j}"
        lines.append(imp.format(fn=FNS[fi], alias=alias))
        calls.append(call.format(fn=FNS[fi], alias=alias))
        bound[call.format(fn=FNS[fi], alias=alias)] = FNS[fi]
    want = [f"{LIB}::{bound[c]}" for c in calls]
    src = "\n".join(lines) + "\n\ndef entry():\n" + "".join(
        f"    {c}\n" for c in calls)
    assert _resolve_entry(src) == want, src


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.sampled_from(["torch.as_tensor", "torch.tensor",
                        "torch.asarray"]), _alias)
def test_an_aliased_ingest_seeds_ingests(name, alias):
    """`from torch import as_tensor as x; x(a, device=dev)` is an ingest:
    the fact reads the resolved target, the device keyword the call."""
    mod, _, fn = name.rpartition(".")
    src = (f"from {mod} import {fn} as {alias}\n"
           "\n"
           "def entry(a, dev):\n"
           f"    {alias}(a, device=dev)\n"
           f"    {alias}(a)\n")
    mi = extract_module(src, "proj.app", "proj/app.py")
    with_dev, without = mi.functions["entry"].calls
    assert F.INGESTS in F.classify_call(with_dev)
    assert F.INGESTS not in F.classify_call(without)


def test_unknown_names_never_misresolve():
    rng = random.Random(1234)
    for _ in range(20):
        name = "ghost_" + "".join(rng.choice("abcdef") for _ in range(8))
        src = f"import proj.lib\n\ndef entry():\n    {name}()\n"
        assert _resolve_entry(src) == [None]
