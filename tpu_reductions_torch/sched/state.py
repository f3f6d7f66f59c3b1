"""Crash-safe plan state: resume the plan, not the script.

The counterpart of tpu_reductions/sched/state.py, in its file format, so
a state either package wrote resumes in the other. One artifact
`{**meta, "complete": bool, "window_t0": t, "tasks": {...}}`, written
atomically (utils/jsonio) after every transition. A prior state resumes
only when every meta key (version, registry hash, platform) matches; one
left `complete: false` by an exit 3 or 4 or a kill resumes its window
(same window_t0, settled tasks stay settled), and a `complete: true` one
is a finished window: the next invocation plans afresh.

A task is recorded `picked` before it runs. A re-invocation that finds a
pick never recorded done consults the task's completion artifact:
complete and fresh, the task finished and only its record died (status
`reconciled`); otherwise the pick is dropped and the task is eligible
again. Offline: no device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.sched.tasks import Task, artifact_complete
from tpu_reductions_torch.utils.jsonio import atomic_json_dump

STATE_VERSION = 1
# terminal statuses: the task consumed its window opportunity.
# "aborted" (the window died mid-task, rc 3/4) is deliberately NOT
# settled: the task never got its chance — a resume re-plans it, and
# whatever rows it persisted before the death resume at the task's own
# grain (bench/resume.py).
_SETTLED = ("done", "reconciled", "failed", "budget-cut", "skipped")


class PlanState:
    """One window's plan ledger (module docstring has the contract)."""

    def __init__(self, path: Optional[str], meta: dict,
                 now: Optional[float] = None,
                 readonly: bool = False) -> None:
        """`readonly=True` (the --plan-only contract: print the plan,
        touch nothing) still LOADS a resumable prior state but never
        writes one."""
        self.path = os.fspath(path) if path is not None else None
        self.meta = json.loads(json.dumps(meta))
        self.readonly = readonly
        self.tasks: Dict[str, dict] = {}
        now = time.time() if now is None else now
        self.window_t0 = now
        prior = self._load_prior()
        if prior is not None:
            self.window_t0 = float(prior.get("window_t0", now))
            for name, rec in prior.get("tasks", {}).items():
                if isinstance(rec, dict):
                    self.tasks[name] = rec
            if not readonly:
                ledger.emit("resume.decision", mode="resume-plan",
                            path=self.path, prior_tasks=len(self.tasks),
                            window_t0=self.window_t0)
        self._persist(complete=False)

    def _load_prior(self) -> Optional[dict]:
        if self.path is None or not os.path.exists(self.path):
            return None
        try:
            data = json.loads(open(self.path).read())
        except (OSError, ValueError):
            return None   # truncated by a pre-atomic interrupt: fresh
        if not isinstance(data, dict) or data.get("complete") is True:
            return None   # finished window: plan fresh
        if not all(data.get(k) == v for k, v in self.meta.items()):
            return None   # different registry/platform: never resume
        return data

    # -- transitions (each persists atomically; a death between a
    #    transition and its persist loses at most that transition,
    #    which reconcile() re-derives from the task artifacts) --------

    def record_pick(self, task: Task, est_s: float) -> None:
        self.tasks[task.name] = {"status": "picked",
                                 "planned_s": round(est_s, 3),
                                 "value": task.value,
                                 "picked_at": round(time.time(), 3)}
        self._persist(complete=False)

    def record_done(self, name: str, rc: int, actual_s: float,
                    status: str) -> None:
        rec = self.tasks.setdefault(name, {})
        rec.update({"status": status, "rc": rc,
                    "actual_s": round(actual_s, 3)})
        self._persist(complete=False)

    def record_skip(self, name: str, reason: str) -> None:
        self.tasks[name] = {"status": "skipped", "reason": reason}
        self._persist(complete=False)

    def finalize(self) -> None:
        """The plan ran dry: mark the window's record complete (the
        next invocation plans fresh)."""
        self._persist(complete=True)

    def _persist(self, complete: bool) -> None:
        if self.path is None or self.readonly:
            return
        atomic_json_dump(self.path, {
            **self.meta, "complete": complete,
            "window_t0": round(self.window_t0, 3),
            "tasks": self.tasks})
        ledger.emit("artifact.persist", path=self.path,
                    rows=len(self.tasks), complete=complete,
                    grain="plan")

    # -- queries ------------------------------------------------------

    def reconcile(self, tasks: Sequence[Task]) -> List[str]:
        """Settle stale 'picked' entries after a death (module
        docstring); returns the reconciled slugs."""
        index = {t.name: t for t in tasks}
        fixed = []
        for name, rec in list(self.tasks.items()):
            if rec.get("status") != "picked":
                continue
            t = index.get(name)
            if t is not None and t.done_artifact and artifact_complete(
                    t.done_artifact, self.window_t0):
                rec.update({"status": "reconciled", "rc": 0})
                fixed.append(name)
            else:
                del self.tasks[name]   # eligible again
        self._persist(complete=False)
        return fixed

    def settled(self, name: str) -> bool:
        return self.tasks.get(name, {}).get("status") in _SETTLED

    def attempted(self, name: str) -> bool:
        """Whether the task consumed its opportunity this window (any
        recorded status at all counts — `requires` gates on attempted,
        not on success: a smoke that FAILED still vetted lowering)."""
        return name in self.tasks


def plan_vs_actual_markdown(state: dict) -> str:
    """The committed plan-vs-actual record, rendered for report.md /
    WINDOW_SUMMARY.md (bench/regen.py folds it in). Pure formatting over a persisted state dict."""
    tasks = state.get("tasks") or {}
    lines = ["## plan vs actual (scheduler)", "",
             "| task | planned s | actual s | status |",
             "|---|---|---|---|"]
    for name in sorted(tasks, key=lambda n: tasks[n].get("picked_at",
                                                         float("inf"))):
        rec = tasks[name]
        planned = rec.get("planned_s")
        actual = rec.get("actual_s")
        status = rec.get("status", "?")
        if status == "skipped" and rec.get("reason"):
            status = f"skipped ({rec['reason']})"
        lines.append(
            f"| {name} "
            f"| {planned if planned is not None else '-'} "
            f"| {actual if actual is not None else '-'} "
            f"| {status} |")
    if not tasks:
        lines.append("| (no tasks planned) | - | - | - |")
    state_done = "complete" if state.get("complete") else "interrupted"
    lines.append("")
    lines.append(f"plan state: {state_done}; "
                 f"window_t0={state.get('window_t0', '-')}")
    return "\n".join(lines)
