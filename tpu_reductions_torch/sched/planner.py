"""Greedy value per expected second against the remaining window.

The counterpart of tpu_reductions/sched/planner.py, with its rules, so
the same tasks, state, priors and `now` give the same plan in both
packages:

  1. a task settled this window, or whose completion artifact is
     complete and fresh (tasks.artifact_complete), leaves the plan;
  2. `requires` gates a task until its prerequisites were attempted this
     window (a failed smoke still counts);
  3. hazard tasks are eligible only after every other task;
  4. the rest order by value / expected seconds (sched/priors.py)
     through the shared knapsack (sched/knapsack.py), each marked `fits`
     against the cumulative remaining-window estimate; the top pick runs
     whatever its mark.

Replanning is calling `plan()` again: a pure function of (registry,
state, priors, now).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from tpu_reductions_torch.sched.knapsack import greedy_plan
from tpu_reductions_torch.sched.priors import Priors
from tpu_reductions_torch.sched.state import PlanState
from tpu_reductions_torch.sched.tasks import Task, artifact_complete


@dataclass(frozen=True)
class PlanEntry:
    """One planned pick: the task plus the estimates that ranked it."""
    task: Task
    est_s: float
    ratio: float          # value / est_s — the greedy key
    fits: bool            # inside the cumulative remaining estimate
    cumulative_s: float
    compile: str = "-"    # cold/warm standing of the task's surfaces
    #                       (priors.compile_status — the compile
    #                       observatory's column, )


@dataclass(frozen=True)
class Plan:
    """The ordered plan + the artifact-skips discovered while planning
    (the caller records them: planning is pure, recording is not)."""
    entries: List[PlanEntry]
    remaining_s: float
    skips: List[tuple]    # (task_name, reason)

    @property
    def next_entry(self) -> Optional[PlanEntry]:
        return self.entries[0] if self.entries else None


def plan(tasks: Sequence[Task], state: PlanState, priors: Priors,
         now: Optional[float] = None) -> Plan:
    """Build the current plan (module docstring has the rules)."""
    now = time.time() if now is None else now
    remaining = priors.remaining_s(state.window_t0, now)
    skips: List[tuple] = []
    open_tasks: List[Task] = []
    for t in tasks:
        if state.settled(t.name):
            continue
        if t.done_artifact and artifact_complete(t.done_artifact,
                                                 state.window_t0):
            skips.append((t.name, "artifact-complete"))
            continue
        open_tasks.append(t)
    attempted_or_skipped = {t.name for t in tasks
                            if state.attempted(t.name)}
    attempted_or_skipped.update(name for name, _ in skips)
    in_registry = {t.name for t in tasks}

    def eligible(t: Task) -> bool:
        # a prerequisite absent from the active registry (--only
        # filter, rehearsal profile) can never be attempted — it must
        # not deadlock the tasks behind it
        return all(r in attempted_or_skipped or r not in in_registry
                   for r in t.requires)

    normal = [t for t in open_tasks if not t.hazard and eligible(t)]
    # requires-blocked tasks still belong in the printed plan (after
    # their prerequisites); order the pools separately then concatenate
    blocked = [t for t in open_tasks if not t.hazard and not eligible(t)]
    hazard = [t for t in open_tasks if t.hazard]

    ranked = greedy_plan([normal, blocked, hazard],
                         value=lambda t: t.value,
                         cost=priors.estimate,
                         budget_s=remaining,
                         tie_key=lambda t: t.name)
    entries = [PlanEntry(task=r.item, est_s=r.cost, ratio=r.ratio,
                         fits=r.fits, cumulative_s=r.cumulative,
                         compile=priors.compile_status(r.item))
               for r in ranked]
    return Plan(entries=entries, remaining_s=remaining, skips=skips)


def render_table(p: Plan) -> str:
    """The --plan-only table: stable for a given (registry, priors,
    state) — the acceptance contract prints it twice and diffs."""
    lines = [f"{'#':>2} {'task':<18} {'value':>7} {'est s':>8} "
             f"{'val/s':>8} {'cum s':>8} {'compile':>7} fits"]
    for i, e in enumerate(p.entries):
        flag = "yes" if e.fits else "no"
        if e.task.hazard:
            flag += " [hazard:last]"
        lines.append(f"{i:>2} {e.task.name:<18} {e.task.value:>7.0f} "
                     f"{e.est_s:>8.1f} {e.ratio:>8.3f} "
                     f"{e.cumulative_s:>8.1f} {e.compile:>7} {flag}")
    for name, reason in p.skips:
        lines.append(f"   {name:<18} -- skipped: {reason}")
    lines.append(f"remaining-window estimate: {p.remaining_s:.1f} s "
                 f"({len(p.entries)} task(s) planned)")
    return "\n".join(lines)
