"""Duration priors and the window-length model, learned from ledger
history.

The counterpart of tpu_reductions/sched/priors.py. From the ledgers
(obs/timeline.read_ledger):

  * `estimate(task)`: this window's observed duration (`observe`, fed by
    the executor), else the median of `sched.done` / `step.end` history
    for the task's slug or title, else the registry's budget_s. That
    last fallback sheds the cold-build seconds the compile ledger banked
    (obs/compile.CompileModel) when every surface the task declares is
    warm, down to a floor of a quarter of the budget;
  * `window_quantile(q)` / `remaining_s(window_t0, now)`: a quantile
    over recorded window lengths (event clusters split at WINDOW_GAP_S),
    DEFAULT_WINDOW_S without history; never negative;
  * `span_median(name)`: per-span medians of the reconstructed span tree
    (obs/critical_path.span_medians).

Offline: reads JSONL files, touches no device.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

from tpu_reductions_torch.obs.timeline import read_ledger
from tpu_reductions_torch.sched.tasks import Task

# the cold-start window prior, the JAX package's (the same tasks, state
# and history plan the same in both packages)
DEFAULT_WINDOW_S = 360.0
# event-time gap that splits ledger history into distinct windows: the
# watcher polls every ~20 s while idle, so anything past 30 min of
# silence is a new window, not a slow step
WINDOW_GAP_S = 1800.0


def scan_history(paths: Iterable[str]) -> dict:
    """Parse ledger files into {'durations': {name: [s, ...]},
    'windows': [s, ...], 'spans': {name: [s, ...]}}. Unreadable/empty
    files are skipped — history is an optimization, never a failure.
    The 'spans' pool is the causal-trace evidence: per-span-name durations from the
    reconstructed tree, the sub-task axis `Priors.span_median` serves
    back to any consumer that wants finer grain than whole tasks.
    read_ledger stitches a rotated `<path>.1` segment automatically."""
    durations: Dict[str, List[float]] = {}
    windows: List[float] = []
    spans: Dict[str, List[float]] = {}
    for path in paths:
        if not path or not os.path.exists(path):
            continue
        try:
            events, _torn = read_ledger(path)
        except OSError:
            continue
        if not events:
            continue
        _scan_durations(events, durations)
        windows.extend(_cluster_windows(events))
        _scan_spans(events, spans)
    return {"durations": durations, "windows": windows, "spans": spans}


def _scan_durations(events: Sequence[dict],
                    durations: Dict[str, List[float]]) -> None:
    """step.start/step.end pairs (pre-scheduler sessions, keyed by the
    step title) and sched.done events (which carry their own actual_s)
    both feed the same sample pool."""
    pending: Dict[str, float] = {}
    for e in events:
        ev = e.get("ev")
        if ev == "step.start" and isinstance(e.get("name"), str):
            pending[e["name"]] = e["t"]
        elif ev == "step.end" and isinstance(e.get("name"), str):
            t0 = pending.pop(e["name"], None)
            if t0 is not None and e["t"] > t0:
                durations.setdefault(e["name"], []).append(e["t"] - t0)
        elif ev == "sched.done" and isinstance(e.get("task"), str):
            a = e.get("actual_s")
            if isinstance(a, (int, float)) and a > 0:
                durations.setdefault(e["task"], []).append(float(a))


def _scan_spans(events: Sequence[dict],
                spans: Dict[str, List[float]]) -> None:
    """Fold one ledger's reconstructed span durations into the pool
    (cut/synthetic closes excluded — a span the death clipped is not a
    duration sample)."""
    try:
        from tpu_reductions_torch.obs.critical_path import span_medians
        for name, med in span_medians(events).items():
            spans.setdefault(name, []).append(med)
    except Exception:
        # span evidence is gravy: a malformed ledger must not stop the
        # planner from estimating with the coarser pools
        pass


def _cluster_windows(events: Sequence[dict]) -> List[float]:
    """Window lengths from event-time clusters: consecutive events more
    than WINDOW_GAP_S apart start a new window. Zero-length clusters
    (a lone probe event) are dropped — they are watcher heartbeats,
    not windows."""
    out: List[float] = []
    start = prev = events[0]["t"]
    for e in events[1:]:
        if e["t"] - prev > WINDOW_GAP_S:
            if prev > start:
                out.append(prev - start)
            start = e["t"]
        prev = e["t"]
    if prev > start:
        out.append(prev - start)
    return out


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0


def _quantile(vals: Sequence[float], q: float) -> float:
    s = sorted(vals)
    if not s:
        raise ValueError("quantile of empty history")
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


class Priors:
    """The planner's cost model: per-task duration estimates + the
    remaining-window estimate, updated online as tasks finish, with
    the compile observatory's cold/warm axis folded into the static
    fallback (module docstring)."""

    def __init__(self, history: Optional[dict] = None,
                 compile_model=None, window_q: float = 0.5) -> None:
        history = history or {"durations": {}, "windows": []}
        self._durations: Dict[str, List[float]] = {
            k: list(v) for k, v in history.get("durations", {}).items()}
        self._windows: List[float] = list(history.get("windows", []))
        self._spans: Dict[str, List[float]] = {
            k: list(v) for k, v in history.get("spans", {}).items()}
        self._online: Dict[str, float] = {}
        self._compile = compile_model   # obs/compile.CompileModel
        self.window_q = window_q        # the quantile remaining_s plans on

    @classmethod
    def from_ledgers(cls, paths: Iterable[str],
                     compile_ledger: Optional[str] = None,
                     platform: Optional[str] = None) -> "Priors":
        """Build from committed ledger histories (CLI default:
        obs_ledger.jsonl in the cwd; --history adds more) plus, when
        `compile_ledger` names a committed compile_ledger.json, the
        observatory's cold/warm model filtered to `platform`'s rows."""
        model = None
        if compile_ledger:
            from tpu_reductions_torch.obs.compile import CompileModel
            model = CompileModel.from_file(compile_ledger,
                                           platform=platform)
        return cls(scan_history(paths), compile_model=model)

    def observe(self, name: str, seconds: float) -> None:
        """Online update: a task finished this window — its actual
        duration becomes the sharpest estimate for a re-pick (retries
        after a budget cut) and joins the sample pool for any ledger
        scan a LATER window performs."""
        if seconds > 0:
            self._online[name] = seconds
            self._durations.setdefault(name, []).append(seconds)

    def estimate(self, task: Task) -> float:
        """Expected duration: this window's observation, else the
        history median (slug first, then the step title
        the pre-scheduler ledgers keyed on), else the static budget —
        discounted by the cache-banked compile seconds when every
        surface the task declares is warm (module docstring; the floor
        keeps a mis-declared surface list from zeroing an estimate)."""
        if task.name in self._online:
            return self._online[task.name]
        for key in (task.name, task.title):
            samples = self._durations.get(key)
            if samples:
                return _median(samples)
        base = float(task.budget_s)
        if self._compile is not None and task.surfaces and \
                self._compile.status(task.surfaces) == "warm":
            saved = self._compile.saved_s(task.surfaces)
            if saved > 0:
                base = max(base - saved, 0.25 * float(task.budget_s))
        return base

    def compile_status(self, task: Task) -> str:
        """The task's cold/warm standing for the plan table
        (sched/planner.render_table): 'warm'/'cold'/'mixed' from the
        compile observatory, '-' when the task declares no surfaces or
        no model is loaded."""
        if self._compile is None or not task.surfaces:
            return "-"
        return self._compile.status(task.surfaces)

    def span_median(self, name: str) -> Optional[float]:
        """Median duration for one span name across the scanned ledger
        history. None when the history never saw the span."""
        samples = self._spans.get(name)
        return _median(samples) if samples else None

    def window_quantile(self, q: float = 0.5) -> float:
        """The window-length model: quantile of recorded flap history,
        DEFAULT_WINDOW_S when no history exists."""
        if not self._windows:
            return DEFAULT_WINDOW_S
        return _quantile(self._windows, q)

    def remaining_s(self, window_t0: float, now: float,
                    q: Optional[float] = None) -> float:
        """Expected seconds left in THIS window (never negative: an
        outlived window keeps planning — every further second is a
        bonus, see module docstring)."""
        q = self.window_q if q is None else q
        return max(0.0, self.window_quantile(q) - max(0.0, now - window_t0))
