"""CLI: plan and execute a window of tasks, or serve one decision at a
time.

The counterpart of tpu_reductions/sched/__main__.py:

    python -m tpu_reductions_torch.sched                  # full run
    python -m tpu_reductions_torch.sched --plan-only      # the table
    python -m tpu_reductions_torch.sched --next --emit=shell   # one pick
    python -m tpu_reductions_torch.sched --record TASK --rc N --elapsed S

The full run executes the plan (`--platform=cpu` takes the rehearsal
profile: chip-only tasks are recorded skipped, the others run their
rehearsal commands); a run killed mid-plan resumes. `--next` prints one
pick (eval-able SCHED_TASK_* assignments with `--emit=shell`; exit 10
when the plan is complete), and `--record` feeds a finished task back.
`--state`, `--tasks`, `--only`, `--history`, `--compile-ledger` and
`--window-quantile` as in JAX; the state defaults to
`out/sched_state.json` and the compile ledger to
`out/compile_ledger.json`.

Exit codes: 0 plan complete, 3 or 4 a window death propagated from a
task (utils/watchdog.py), 10 plan complete (--next), 2 usage.
"""

from __future__ import annotations

import argparse
import os
import shlex
import sys
from typing import List

from tpu_reductions_torch.config import PLATFORMS
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.sched import executor, planner, tasks as tasks_mod
from tpu_reductions_torch.sched.priors import Priors
from tpu_reductions_torch.sched.state import STATE_VERSION, PlanState

PLAN_COMPLETE_EXIT = 10
DEFAULT_STATE = os.path.join("out", "sched_state.json")
DEFAULT_HISTORY = os.path.join("out", "obs_ledger.jsonl")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.sched",
        description="Value-per-expected-second window scheduler "
                    "(docs/SCHEDULER.md)")
    p.add_argument("--plan-only", action="store_true",
                   help="print the plan table and exit (no device, no "
                        "state writes)")
    p.add_argument("--next", dest="next_", action="store_true",
                   help="replan, record ONE pick, print it for the "
                        "shell loop (exit 10 when the plan is done)")
    p.add_argument("--emit", choices=("shell", "text"), default="text",
                   help="--next output format (shell = eval-able "
                        "SCHED_TASK_* assignments)")
    p.add_argument("--record", metavar="TASK", default=None,
                   help="record a finished task (shell loop feedback)")
    p.add_argument("--rc", type=int, default=0,
                   help="exit code for --record")
    p.add_argument("--elapsed", type=float, default=0.0,
                   help="wall-clock seconds for --record")
    p.add_argument("--state", default=DEFAULT_STATE,
                   help="plan state artifact (sched/state.py)")
    p.add_argument("--tasks", dest="tasks_file", default=None,
                   help="JSON task registry override (tests, chaos)")
    p.add_argument("--platform", choices=PLATFORMS, default=None,
                   help="cpu = rehearsal profile (chip-only tasks "
                        "recorded skipped, rehearsal-scale commands)")
    p.add_argument("--only", default=None,
                   help="comma-separated task slugs to restrict to")
    p.add_argument("--history", action="append", default=None,
                   help="extra ledger file(s) for duration/window "
                        "priors (default: the active ledger)")
    p.add_argument("--compile-ledger", dest="compile_ledger",
                   default=None,
                   help="compile observatory artifact feeding the "
                        "cold/warm duration priors (default: "
                        "TPU_REDUCTIONS_COMPILE_LEDGER, else "
                        "out/compile_ledger.json)")
    p.add_argument("--window-quantile", type=float, default=0.5,
                   help="window-length quantile the knapsack plans "
                        "against")
    return p


def _active(ns) -> tuple:
    """(tasks, excluded, meta, priors) for the invocation."""
    only = ([s.strip() for s in ns.only.split(",") if s.strip()]
            if ns.only else None)
    if ns.tasks_file:
        active = tasks_mod.load_tasks_file(ns.tasks_file)
        if only is not None:
            active = [t for t in active if t.name in only]
        excluded: List = []
        if ns.platform == "cpu":
            excluded = [t for t in active if t.chip_only]
            active = [t for t in active if not t.chip_only]
    else:
        active = tasks_mod.registry(platform=ns.platform, only=only)
        excluded = tasks_mod.rehearsal_excluded(platform=ns.platform,
                                                only=only)
    tasks_mod.by_name(active)    # duplicate slugs fail loudly
    meta = {"version": STATE_VERSION,
            "registry": tasks_mod.registry_hash(active),
            "platform": ns.platform or "default"}
    history = list(ns.history or [])
    env_ledger = ledger.resolved_path()
    if env_ledger:
        history.append(env_ledger)
    elif not history:
        history.append(DEFAULT_HISTORY)
    # the compile ledger's cold/warm axis, its rows filtered to the
    # planning platform: a build on the CPU says nothing of the card's
    from tpu_reductions_torch.obs.compile import DEFAULT_LEDGER, ENV_PATH
    compile_ledger = ns.compile_ledger \
        or os.environ.get(ENV_PATH) or DEFAULT_LEDGER
    priors = Priors.from_ledgers(
        history, compile_ledger=compile_ledger,
        platform=("cpu" if ns.platform == "cpu" else "gpu"))
    priors.window_q = ns.window_quantile
    return active, excluded, meta, priors


def _emit_next(entry, emit: str) -> None:
    t = entry.task
    if emit == "shell":
        print(f"SCHED_TASK_SLUG={shlex.quote(t.name)}")
        print(f"SCHED_TASK_NAME={shlex.quote(t.title)}")
        print(f"SCHED_TASK_BUDGET={int(t.budget_s)}")
        print(f"SCHED_TASK_ARTIFACTS={shlex.quote(' '.join(t.artifacts))}")
        print(f"SCHED_TASK_CMD={shlex.quote(t.command)}")
    else:
        print(f"{t.name} (budget {int(t.budget_s)}s, est "
              f"{entry.est_s:.1f}s): {t.command}")


def main(argv=None) -> int:
    ns = _build_parser().parse_args(argv)
    modes = sum((ns.plan_only, ns.next_, ns.record is not None))
    if modes > 1:
        print("sched: --plan-only / --next / --record are exclusive",
              file=sys.stderr)
        return 2
    active, excluded, meta, priors = _active(ns)

    if ns.plan_only:
        state = PlanState(ns.state, meta, readonly=True)
        p = planner.plan(active, state, priors)
        print(planner.render_table(p))
        for t in excluded:
            print(f"   {t.name:<18} -- skipped: chip-only "
                  "(rehearsal profile)")
        return 0

    if ns.next_ or ns.record is not None:
        ledger.arm()   # one-shot modes append to the session's ledger
    else:
        # full run: the session must open BEFORE the plan state's
        # first persist so the timeline attributes it correctly
        ledger.arm_session("sched",
                           argv=list(argv) if argv else sys.argv[1:])
    if os.path.dirname(ns.state):
        os.makedirs(os.path.dirname(ns.state), exist_ok=True)
    state = PlanState(ns.state, meta)

    if ns.record is not None:
        status = executor._status_for(ns.rc)
        priors.observe(ns.record, ns.elapsed)
        state.record_done(ns.record, ns.rc, ns.elapsed, status)
        ledger.emit("sched.done", task=ns.record, rc=ns.rc,
                    actual_s=round(ns.elapsed, 3), status=status)
        return 0

    if ns.next_:
        # captured BEFORE this invocation's own skip records: only a
        # plan that follows earlier picks/outcomes is a re-plan
        prior_activity = bool(state.tasks)
        for t in excluded:
            if not state.attempted(t.name):
                ledger.emit("sched.skip", task=t.name,
                            reason="chip-only")
                state.record_skip(t.name, "chip-only")
        state.reconcile(active)
        p = planner.plan(active, state, priors)
        executor.record_skips(p, state)
        executor.emit_plan(p, replan=prior_activity)
        entry = p.next_entry
        if entry is None:
            state.finalize()
            print("sched: plan complete", file=sys.stderr)
            return PLAN_COMPLETE_EXIT
        ledger.emit("sched.pick", task=entry.task.name,
                    est_s=round(entry.est_s, 1),
                    value=entry.task.value, fits=entry.fits)
        state.record_pick(entry.task, entry.est_s)
        _emit_next(entry, ns.emit)
        return 0

    # full plan-and-execute run (rehearsal + standalone windows)
    return executor.run_plan(active, state, priors, excluded=excluded)


if __name__ == "__main__":
    # redlint: disable=RED017 -- the one touch on this path is the `spin` fault's kernel (faults/inject.py), which launches only in a process that has initialized CUDA already; the scheduler never does, so there the action raises before it reaches the card, and its tasks, each a process of its own, arm their own watchdogs
    sys.exit(main())
