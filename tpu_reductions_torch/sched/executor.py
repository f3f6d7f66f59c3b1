"""Plan and execute: spend the window, persist every decision.

The counterpart of tpu_reductions/sched/executor.py. Each picked task
runs as a subprocess (`bash -c <task.command>`) in its own process group,
so its entry point arms its own flight recorder and watchdog and
persists its rows as bench/resume.py does; the executor itself touches
no device.

Budget: at the task's budget_s the whole process group gets SIGINT
(Python raises KeyboardInterrupt and the drivers persist and drain),
then SIGTERM, then a kill, each after the grace
(TPU_REDUCTIONS_SCHED_KILL_GRACE_S, default 120 s); the kill reaches the
CUDA children of the task too. A budget cut records rc 124.

Window death: a task that exits 3 (dead relay) or 4 (hang; both
utils/watchdog.py) ends the run with the same code and the plan state
left `complete: false`; the next invocation resumes it (sched/state.py).
Between tasks the executor re-probes the relay, only on a tunneled host
(utils/watchdog.tunneled_environment). The `sched.task` fault point
fires between a pick and its launch.

Every decision is a ledger event: `sched.plan`, `sched.pick`,
`sched.skip`, `sched.done`, `sched.replan`.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence

from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.obs import ledger, trace
from tpu_reductions_torch.sched import planner
from tpu_reductions_torch.sched.priors import Priors
from tpu_reductions_torch.sched.state import PlanState
from tpu_reductions_torch.sched.tasks import Task
from tpu_reductions_torch.utils.watchdog import (HANG_EXIT_CODE,
                                           WATCHDOG_EXIT_CODE,
                                           relay_alive,
                                           tunneled_environment)

WINDOW_DEATH_CODES = (WATCHDOG_EXIT_CODE, HANG_EXIT_CODE)
PLAN_COMPLETE_RC = 0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def _log(msg: str) -> None:
    print(f"sched: {msg}", file=sys.stderr, flush=True)


def run_task(task: Task, budget_s: Optional[float] = None,
             env: Optional[dict] = None) -> int:
    """One task subprocess under the INT-first budget discipline
    (module docstring); returns its exit code (124 = budget cut, the
    `timeout` convention)."""
    budget = float(budget_s if budget_s is not None else task.budget_s)
    grace = _env_float("TPU_REDUCTIONS_SCHED_KILL_GRACE_S", 120.0)
    proc = subprocess.Popen(["bash", "-c", task.command],
                            env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=budget)
    except subprocess.TimeoutExpired:
        pass
    else:
        # the task ended on its own, perhaps by os._exit (the watchdog's
        # exit 4), which runs no cleanup: no process of its group, CUDA
        # children included, outlives it
        _kill_group(proc.pid)
        return rc
    _log(f"task {task.name} hit its {budget:.0f}s budget: SIGINT "
         "(drain-first discipline)")
    for sig, wait_s in ((signal.SIGINT, grace),
                        (signal.SIGTERM, grace / 4 + 1)):
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            break
        try:
            proc.wait(timeout=wait_s)
            break
        except subprocess.TimeoutExpired:
            continue
    if proc.poll() is None:
        # the backstop for a task too wedged to honour the interrupt
        if not _kill_group(proc.pid):
            proc.kill()
        proc.wait()
    else:
        # the task ended: no process of its group outlives it
        _kill_group(proc.pid)
    return 124


def _kill_group(pgid: int) -> bool:
    """SIGKILL every process left in the task's group; False when the
    group is already gone."""
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        return False
    return True


def _status_for(rc: int) -> str:
    if rc == 0:
        return "done"
    if rc in WINDOW_DEATH_CODES:
        return "aborted"
    if rc == 124:
        return "budget-cut"
    return "failed"


def record_skips(p: planner.Plan, state: PlanState) -> None:
    """Persist + emit the artifact-skips a planning pass discovered
    (planning is pure; recording happens here, once per skip)."""
    for name, reason in p.skips:
        ledger.emit("sched.skip", task=name, reason=reason)
        state.record_skip(name, reason)


def emit_plan(p: planner.Plan, replan: bool) -> None:
    ledger.emit("sched.replan" if replan else "sched.plan",
                tasks=[e.task.name for e in p.entries],
                est_s=[round(e.est_s, 1) for e in p.entries],
                remaining_s=round(p.remaining_s, 1))


def run_plan(tasks: Sequence[Task], state: PlanState, priors: Priors,
             excluded: Sequence[Task] = (),
             env: Optional[dict] = None,
             _run=run_task) -> int:
    """The loop: reconcile -> plan -> pick -> run -> record -> replan,
    until the plan runs dry (finalize, exit 0) or the window dies
    (exit 3/4, plan state resumable). `_run` is injectable for
    tests."""
    # trace continuity: a resumed plan whose prior
    # invocation died mid-task (an "aborted" record, or a "picked" one
    # the death left unsettled) marks the seam with an explicit
    # trace.cut — the export closes the torn spans there, and the work
    # below continues under the SAME trace when the re-invocation
    # inherited TPU_REDUCTIONS_TRACE_CTX
    torn = sorted(n for n, rec in state.tasks.items()
                  if rec.get("status") in ("aborted", "picked"))
    if torn:
        trace.cut("window-death-resume", tasks=torn)
    for t in excluded:
        if not state.attempted(t.name):
            ledger.emit("sched.skip", task=t.name, reason="chip-only")
            state.record_skip(t.name, "chip-only")
    reconciled = state.reconcile(tasks)
    for name in reconciled:
        _log(f"task {name} reconciled: its artifact completed before "
             "the last death; not re-measured")
    env = dict(env if env is not None else os.environ)
    # the window epoch doubles as FIRSTROW_T0 for task commands that
    # reference it (headline_bench's doubles-suppression mtime check)
    env.setdefault("FIRSTROW_T0", f"{state.window_t0:.2f}")
    # cross-process propagation: every task subprocess parents its
    # events under the executor's span via TPU_REDUCTIONS_TRACE_CTX
    # (obs/trace.py adopts it at arm time) — one trace per session
    env.update(trace.propagation_env())
    replan = False
    while True:
        p = planner.plan(tasks, state, priors)
        record_skips(p, state)
        emit_plan(p, replan)
        replan = True
        entry = p.next_entry
        if entry is None:
            state.finalize()
            _log("plan complete: every task settled or skipped")
            return PLAN_COMPLETE_RC
        if tunneled_environment() and not relay_alive():
            # the relay died between tasks: stop with the plan resumable
            _log("relay dead between tasks; plan state persisted for "
                 "the next window")
            ledger.emit("sched.done", task=entry.task.name,
                        status="not-started", reason="relay-dead")
            return WATCHDOG_EXIT_CODE
        # chaos seam (faults/inject.py): the `sched.task` point fires
        # between pick and launch — a scripted raise/stall/exit here is
        # the deterministic spelling of "the executor died mid-plan"
        fault_point("sched.task")
        ledger.emit("sched.pick", task=entry.task.name,
                    est_s=round(entry.est_s, 1),
                    value=entry.task.value,
                    fits=entry.fits)
        state.record_pick(entry.task, entry.est_s)
        if not entry.fits:
            _log(f"pick {entry.task.name} does not fit the remaining-"
                 f"window estimate ({p.remaining_s:.0f}s) — running "
                 "anyway: the relay answering is a fact, the estimate "
                 "is a model")
        t0 = time.monotonic()
        rc = _run(entry.task, env=env)
        actual = time.monotonic() - t0
        status = _status_for(rc)
        if rc not in WINDOW_DEATH_CODES:
            # an aborted task's duration is the WINDOW's length, not
            # the task's — feeding it to the priors would teach the
            # planner that dying is fast
            priors.observe(entry.task.name, actual)
        state.record_done(entry.task.name, rc, actual, status)
        ledger.emit("sched.done", task=entry.task.name, rc=rc,
                    actual_s=round(actual, 3),
                    planned_s=round(entry.est_s, 1), status=status)
        _log(f"task {entry.task.name}: {status} rc={rc} "
             f"({actual:.1f}s vs {entry.est_s:.1f}s planned)")
        if rc in WINDOW_DEATH_CODES:
            _log(f"window death (rc={rc}); plan state persisted — "
                 "re-invocation resumes the remaining tasks")
            return rc
