"""The port's window scheduler (tpu_reductions_torch/sched/) against the
JAX package's: the same tasks, state, priors history and `now` give the
same plan and `fits` marks; a plan state written by either package
resumes in the other; the executor on `bash -c` tasks that exit 0, 3 and
4 or overrun their budget (SIGINT, then SIGTERM, then a kill of the whole
process group under a compressed grace); resume after an exit 4; the CLI's
modes and exit codes; and the registry: the JAX slugs, values, budgets,
`requires`, `hazard` and surfaces, with the port's CLIs as commands."""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpu_reductions.sched import planner as jax_planner
from tpu_reductions.sched import tasks as jax_tasks
from tpu_reductions.sched.priors import Priors as JaxPriors
from tpu_reductions.sched.priors import scan_history as jax_scan
from tpu_reductions.sched.state import PlanState as JaxState
from tpu_reductions.sched.state import \
    plan_vs_actual_markdown as jax_markdown
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.sched import executor, planner
from tpu_reductions_torch.sched import tasks as tasks_mod
from tpu_reductions_torch.sched.priors import Priors, scan_history
from tpu_reductions_torch.sched.state import (STATE_VERSION, PlanState,
                                              plan_vs_actual_markdown)
from tpu_reductions_torch.sched.tasks import Task

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    # both compile caches empty: a cold-only surface reads cold in both
    from tpu_reductions.utils import compile_cache as jax_cache
    from tpu_reductions_torch.utils import compile_cache as port_cache
    for mod, sub in ((jax_cache, "jc"), (port_cache, "build")):
        (tmp_path / sub).mkdir()
        monkeypatch.setattr(mod, "_active_dir", str(tmp_path / sub))
    for name in ("TPU_REDUCTIONS_LEDGER", "TPU_REDUCTIONS_FAULTS",
                 "TPU_REDUCTIONS_RELAY_MARKER", "TPU_REDUCTIONS_TRACE_CTX",
                 "TPU_REDUCTIONS_COMPILE_LEDGER"):
        monkeypatch.delenv(name, raising=False)
    ledger.disarm()
    yield
    ledger.disarm()


def _spec(name, value, budget, **kw):
    return {"name": name, "value": value, "budget_s": budget,
            "command": kw.pop("command", "true"), **kw}


# one tasks file: ratio order, a hazard, requires, a fresh artifact, a
# task with history, warm and cold surfaces
SPECS = [
    _spec("alpha", 100, 100), _spec("beta", 10, 5),
    _spec("gamma", 50, 200, requires=["beta"]),
    _spec("hazard", 1000, 10, hazard=True),
    _spec("done_art", 40, 10, done_artifact="done.json"),
    _spec("history", 30, 300),
    _spec("warm_task", 20, 100, surfaces=["k6"]),
    _spec("cold_task", 20, 100, surfaces=["k7"]),
    _spec("blocked", 500, 50, requires=["nobody_yet", "alpha"]),
]
HISTORY = [  # sched.done samples, and two windows 2 h apart
    {"t": 1000.0, "ev": "sched.done", "pid": 1, "task": "history",
     "actual_s": 40.0},
    {"t": 1100.0, "ev": "sched.done", "pid": 1, "task": "history",
     "actual_s": 60.0},
    {"t": 1200.0, "ev": "step.start", "pid": 1, "name": "alpha"},
    {"t": 1290.0, "ev": "step.end", "pid": 1, "name": "alpha"},
    {"t": 9000.0, "ev": "sched.plan", "pid": 2, "tasks": []},
    {"t": 9300.0, "ev": "compile.end", "pid": 2, "surface": "k6",
     "dur_s": 1.5, "trace": "t", "span": "s"},
]
COMPILE = {"kind": "compile-observatory", "version": 1, "complete": True,
           "surfaces": [
               {"surface": "k6", "platform": "gpu", "verdict": "cold",
                "dur_s": 30.0},
               {"surface": "k6", "platform": "gpu", "verdict": "warm",
                "dur_s": 1.0},
               {"surface": "k7", "platform": "gpu", "verdict": "cold",
                "dur_s": 25.0}]}


def _inputs(tmp_path):
    tasks_file = tmp_path / "tasks.json"
    tasks_file.write_text(json.dumps(SPECS))
    hist = tmp_path / "hist.jsonl"
    hist.write_text("\n".join(json.dumps(e) for e in HISTORY) + "\n")
    cl = tmp_path / "cl.json"
    cl.write_text(json.dumps(COMPILE))
    return tasks_file, hist, cl


def _plan_rows(p):
    return ([(e.task.name, round(e.est_s, 9), round(e.ratio, 9), e.fits,
              round(e.cumulative_s, 9), e.compile) for e in p.entries],
            round(p.remaining_s, 9), list(p.skips))


@pytest.mark.parametrize("elapsed", [0.0, 100.0, 250.0, 1000.0])
@pytest.mark.parametrize("recorded", [(), ("beta",), ("beta", "alpha")])
def test_planner_parity(tmp_path, monkeypatch, elapsed, recorded):
    """One tasks file, one state, one history and one `now`: the same
    plan, order, estimates and fits marks in both packages."""
    monkeypatch.chdir(tmp_path)
    tasks_file, hist, cl = _inputs(tmp_path)
    now = 5000.0
    (tmp_path / "done.json").write_text('{"complete": true}')
    os.utime(tmp_path / "done.json", (now, now))
    state = {"version": 1, "registry": "r", "platform": "default",
             "complete": False, "window_t0": now - elapsed,
             "tasks": {n: {"status": "done", "rc": 0, "actual_s": 3.0}
                       for n in recorded}}
    (tmp_path / "state.json").write_text(json.dumps(state))
    meta = {"version": 1, "registry": "r", "platform": "default"}

    port_tasks = tasks_mod.load_tasks_file(str(tasks_file))
    ref_tasks = jax_tasks.load_tasks_file(str(tasks_file))
    assert [dataclasses.asdict(t) for t in port_tasks] \
        == [dataclasses.asdict(t) for t in ref_tasks]
    assert tasks_mod.registry_hash(port_tasks) \
        == jax_tasks.registry_hash(ref_tasks)
    port = planner.plan(
        port_tasks, PlanState(str(tmp_path / "state.json"), meta,
                              readonly=True),
        Priors.from_ledgers([str(hist)], compile_ledger=str(cl),
                            platform="gpu"), now=now)
    ref = jax_planner.plan(
        ref_tasks, JaxState(str(tmp_path / "state.json"), meta,
                            readonly=True),
        JaxPriors.from_ledgers([str(hist)], compile_ledger=str(cl),
                               platform="gpu"), now=now)
    assert _plan_rows(port) == _plan_rows(ref)
    assert planner.render_table(port) == jax_planner.render_table(ref)


def test_priors_history_matches(tmp_path):
    _, hist, _ = _inputs(tmp_path)
    assert scan_history([str(hist)]) == jax_scan([str(hist)])
    port, ref = Priors(scan_history([str(hist)])), JaxPriors(
        jax_scan([str(hist)]))
    for q in (0.0, 0.5, 0.9):
        assert port.window_quantile(q) == ref.window_quantile(q)
    assert port.span_median("compile.end") == ref.span_median("compile.end")
    assert port.remaining_s(0.0, 100.0) == ref.remaining_s(0.0, 100.0)
    port.window_q = 0.9
    assert port.remaining_s(0.0, 100.0) == ref.remaining_s(0.0, 100.0,
                                                           q=0.9)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_plan_state_round_trips_across_the_packages(tmp_path, writer):
    """A state one package left `complete: false` resumes in the other:
    the same window_t0, the same task records, the same markdown."""
    meta = {"version": STATE_VERSION, "registry": "abc",
            "platform": "cpu"}
    path = str(tmp_path / "st.json")
    first = (JaxState if writer == "jax" else PlanState)(path, meta,
                                                        now=1000.0)
    task = Task(name="a", title="a", value=2.0, budget_s=10.0,
                command="true", artifacts=())
    first.record_pick(task, 7.5)
    first.record_done("a", 0, 6.25, "done")
    first.record_skip("b", "chip-only")
    first.record_pick(dataclasses.replace(task, name="c"), 3.0)
    reader = PlanState if writer == "jax" else JaxState
    second = reader(path, meta, now=2000.0)
    assert second.window_t0 == 1000.0
    assert second.tasks == first.tasks
    assert second.settled("a") and second.settled("b")
    assert not second.settled("c") and second.attempted("c")
    data = json.loads(Path(path).read_text())
    assert plan_vs_actual_markdown(data) == jax_markdown(data)
    second.finalize()
    fresh = (JaxState if writer == "jax" else PlanState)(path, meta,
                                                        now=3000.0)
    assert fresh.tasks == {} and fresh.window_t0 == 3000.0
    other = PlanState(path, {**meta, "registry": "other"}, now=4000.0)
    assert other.tasks == {}


def _task(name, value=10.0, budget=60.0, **kw):
    kw.setdefault("command", "true")
    kw.setdefault("artifacts", ())
    return Task(name=name, title=name, value=value, budget_s=budget, **kw)


@pytest.mark.parametrize("code,status", [(0, "done"), (1, "failed"),
                                         (3, "aborted"), (4, "aborted")])
def test_executor_bash_tasks_exit_codes(tmp_path, code, status):
    """A task's exit code settles it, and 3 or 4 end the window with the
    same code and the state incomplete."""
    st = PlanState(str(tmp_path / "st.json"), {"registry": "t"})
    ts = [_task("first", value=10, command=f"exit {code}"),
          _task("second", value=1, command="true")]
    rc = executor.run_plan(ts, st, Priors(), env={**os.environ})
    data = json.loads((tmp_path / "st.json").read_text())
    assert data["tasks"]["first"]["status"] == status
    assert data["tasks"]["first"]["rc"] == code
    if code in (3, 4):
        assert rc == code and data["complete"] is False
        assert "second" not in data["tasks"]
    else:
        assert rc == 0 and data["complete"] is True
        assert data["tasks"]["second"]["status"] == "done"


def test_budget_overrun_escalates_from_sigint(tmp_path, monkeypatch):
    """SIGINT first to the whole group; a task that ignores it gets
    SIGTERM, then a kill, within the compressed grace; its child
    processes die with it."""
    monkeypatch.setenv("TPU_REDUCTIONS_SCHED_KILL_GRACE_S", "1")
    trace = tmp_path / "trace"
    pid_file = tmp_path / "child.pid"
    t = _task("stubborn", budget=1.0, command=(
        f"trap 'echo INT >> {trace}' INT; "
        f"trap 'echo TERM >> {trace}' TERM; "
        # a child deaf to both: only the group's kill ends it
        f"(trap '' INT TERM; exec sleep 60) & echo $! > {pid_file}; "
        "while true; do sleep 0.1; done"))
    t0 = time.monotonic()
    assert executor.run_task(t) == 124
    assert time.monotonic() - t0 < 15
    text = trace.read_text()
    assert "INT" in text and "TERM" in text
    _assert_ends(int(pid_file.read_text()))


def _assert_ends(pid, within_s=5.0):
    deadline = time.monotonic() + within_s
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.05)
    pytest.fail("the task's child survived the kill")


def test_task_that_exits_4_leaves_no_process_of_its_group(tmp_path):
    """A task that ends on its own, as the watchdog's exit 4 does, takes
    the processes it started with it."""
    pid_file = tmp_path / "child.pid"
    t = _task("hung", command=(
        f"sleep 60 & echo $! > {pid_file}; exit 4"))
    assert executor.run_task(t) == 4
    _assert_ends(int(pid_file.read_text()))


def test_budget_overrun_that_drains_on_sigint(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_REDUCTIONS_SCHED_KILL_GRACE_S", "5")
    trace = tmp_path / "trace"
    t = _task("drains", budget=1.0, command=(
        f"trap 'echo INT >> {trace}; exit 0' INT; sleep 30 & wait"))
    t0 = time.monotonic()
    assert executor.run_task(t) == 124
    assert time.monotonic() - t0 < 10
    assert trace.read_text().strip() == "INT"


def _sched(args, cwd, env=None, timeout=120):
    e = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    e.pop("TPU_REDUCTIONS_LEDGER", None)
    e.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.sched", *args],
        cwd=str(cwd), env=e, capture_output=True, text=True,
        timeout=timeout)


def _write_window(tmp_path):
    """Three counted tasks; the middle one exits 4 while HANG is set."""
    tasks = [
        _spec("first", 3, 10, command=f"echo r >> {tmp_path}/first.runs"),
        _spec("hang", 2, 10, command=(
            f"echo r >> {tmp_path}/hang.runs; "
            'if [ -n "$HANG" ]; then exit 4; fi')),
        _spec("last", 1, 10, command=f"echo r >> {tmp_path}/last.runs")]
    (tmp_path / "tasks.json").write_text(json.dumps(tasks))


def test_cli_resumes_after_exit_4_running_only_what_was_left(tmp_path):
    _write_window(tmp_path)
    led = tmp_path / "l.jsonl"
    args = ["--tasks=tasks.json", "--state=st.json"]
    r = _sched(args, tmp_path, {"HANG": "1",
                                "TPU_REDUCTIONS_LEDGER": str(led)})
    assert r.returncode == 4, r.stderr
    st = json.loads((tmp_path / "st.json").read_text())
    assert st["complete"] is False
    assert st["tasks"]["hang"]["status"] == "aborted"
    n = len(led.read_text().splitlines())
    r = _sched(args, tmp_path, {"TPU_REDUCTIONS_LEDGER": str(led)})
    assert r.returncode == 0, r.stderr
    st = json.loads((tmp_path / "st.json").read_text())
    assert st["complete"] is True
    runs = {k: (tmp_path / f"{k}.runs").read_text().count("r")
            for k in ("first", "hang", "last")}
    assert runs == {"first": 1, "hang": 2, "last": 1}
    resumed = [json.loads(line) for line in
               led.read_text().splitlines()[n:]]
    assert [e["task"] for e in resumed if e["ev"] == "sched.pick"] \
        == ["hang", "last"]
    assert any(e["ev"] == "trace.cut" for e in resumed)


def test_cli_sched_task_fault_point_and_resume(tmp_path):
    _write_window(tmp_path)
    args = ["--tasks=tasks.json", "--state=st.json"]
    r = _sched(args, tmp_path, {"TPU_REDUCTIONS_FAULTS": json.dumps(
        {"sched.task": {"after": 1, "action": "exit", "code": 9}})})
    assert r.returncode == 9
    st = json.loads((tmp_path / "st.json").read_text())
    assert st["tasks"]["first"]["status"] == "done"
    assert "hang" not in st["tasks"]
    assert _sched(args, tmp_path).returncode == 0
    assert (tmp_path / "first.runs").read_text().count("r") == 1


def test_cli_next_record_loop_and_exit_10(tmp_path):
    _write_window(tmp_path)
    base = ["--tasks=tasks.json", "--state=st.json"]
    picked = []
    for _ in range(3):
        r = _sched(base + ["--next", "--emit=shell"], tmp_path)
        assert r.returncode == 0, r.stderr
        env = dict(line.split("=", 1) for line in r.stdout.splitlines())
        picked.append(env["SCHED_TASK_SLUG"])
        assert _sched(base + ["--record", env["SCHED_TASK_SLUG"], "--rc",
                              "0", "--elapsed", "1.5"],
                      tmp_path).returncode == 0
    assert picked == ["first", "hang", "last"]
    assert _sched(base + ["--next"], tmp_path).returncode == 10


def test_cli_usage_errors_and_plan_only(tmp_path):
    _write_window(tmp_path)
    r = _sched(["--tasks=tasks.json", "--plan-only", "--next"], tmp_path)
    assert r.returncode == 2
    r = _sched(["--platform=tpu", "--plan-only"], tmp_path)
    assert r.returncode == 2                   # the port's platforms
    r1 = _sched(["--plan-only", "--platform=cpu"], tmp_path)
    r2 = _sched(["--plan-only", "--platform=cpu"], tmp_path)
    assert r1.returncode == 0 and r1.stdout == r2.stdout
    assert "flagship" in r1.stdout and "chip-only" in r1.stdout
    assert not (tmp_path / "out").exists()     # plan-only writes nothing


# ------------------------------------------------------------- registry

def test_registry_keeps_the_jax_slugs_values_and_gates():
    port = {t.name: t for t in tasks_mod.SESSION_TASKS}
    ref = {t.name: t for t in jax_tasks.SESSION_TASKS}
    assert list(port) == list(ref)
    for name, t in port.items():
        r = ref[name]
        assert (t.value, t.budget_s, t.requires, t.hazard, t.chip_only) \
            == (r.value, r.budget_s, r.requires, r.hazard, r.chip_only)
        assert t.surfaces == tuple("torch" if s == "xla" else s
                                   for s in r.surfaces)
        assert (t.rehearsal_command is None) == (r.rehearsal_command is None)
    assert {t.name for t in tasks_mod.rehearsal_excluded("cpu")} \
        == {t.name for t in jax_tasks.rehearsal_excluded("cpu")}


@pytest.mark.parametrize("task", tasks_mod.SESSION_TASKS,
                         ids=lambda t: t.name)
def test_registry_commands_are_the_ports_clis(task):
    for cmd in filter(None, (task.command, task.rehearsal_command)):
        assert "tpu_reductions_torch" in cmd
        assert "bench.py" not in cmd and "scripts/" not in cmd
        assert "tpu_reductions." not in cmd.replace(
            "tpu_reductions_torch.", "")
        for word in cmd.split():
            if word.startswith("--out="):
                assert word.startswith("--out=out/"), word
    if task.rehearsal_command:
        assert "--platform=cpu" in task.rehearsal_command
        assert "--platform=cpu" not in task.command
    for path in task.artifacts + ((task.done_artifact,)
                                  if task.done_artifact else ()):
        assert path.startswith("out/"), path


def test_rehearsal_registry_swaps_commands():
    cpu = tasks_mod.registry(platform="cpu")
    assert all(not t.chip_only for t in cpu)
    by = {t.name: t for t in tasks_mod.SESSION_TASKS}
    for t in cpu:
        assert t.command == (by[t.name].rehearsal_command
                             or by[t.name].command)
    assert [t.name for t in tasks_mod.registry(only=["smoke"])] == ["smoke"]
