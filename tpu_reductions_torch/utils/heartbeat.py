"""Forward-progress heartbeat: liveness keyed on work.

The counterpart of tpu_reductions/utils/heartbeat.py. Every device region
the execution core runs (exec/core.py) opens a `guard(phase)`; `tick`
refreshes the mark from inside a long guarded loop and may relabel the
phase; `snapshot()` reports {in_flight, age_s, phase, beats}; and
`deadline_for(phase)` is the staleness budget of a phase
(TPU_REDUCTIONS_HEARTBEAT_COMPILE_DEADLINE_S for "compile", default 300 s;
TPU_REDUCTIONS_HEARTBEAT_DEADLINE_S otherwise, default 120 s; <= 0
disables). Every phase transition lands as an `hb.phase` event in the
ledger (obs/ledger.py), which stamps the open phase onto every event.

The watchdog (utils/watchdog.py) reads the snapshot every cycle and ends
a process whose open guard is older than its deadline with exit 4, after
a `watchdog.exit` event. Every mark consults the `heartbeat.tick` fault point
(faults/inject.py): a `{"action": "suppress"}` spec freezes the mark.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Optional

from tpu_reductions_torch.faults.inject import fault_point

# the JAX watchdog's exit code for a guarded region past its deadline
HANG_EXIT_CODE = 4

PHASE_COMPILE = "compile"
DEFAULT_DEADLINE_S = 120.0
DEFAULT_COMPILE_DEADLINE_S = 300.0

_lock = threading.Lock()
_depth = 0
_phases: List[str] = []
_mark: Optional[float] = None   # monotonic time of the last progress
_beats = 0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def deadline_for(phase: Optional[str]) -> float:
    """The staleness budget of `phase` in seconds (<= 0 disables)."""
    if phase == PHASE_COMPILE:
        return _env_float("TPU_REDUCTIONS_HEARTBEAT_COMPILE_DEADLINE_S",
                          DEFAULT_COMPILE_DEADLINE_S)
    return _env_float("TPU_REDUCTIONS_HEARTBEAT_DEADLINE_S",
                      DEFAULT_DEADLINE_S)


def _emit_phase(prev: Optional[str], new: Optional[str]) -> None:
    """One `hb.phase` event, outside _lock (the ledger reads snapshot())."""
    try:
        from tpu_reductions_torch.obs import ledger
        ledger.emit("hb.phase", phase=new, prev=prev)
    except Exception:
        pass


def _touch(phase: Optional[str] = None) -> None:
    global _mark, _beats
    spec = fault_point("heartbeat.tick")
    if spec is not None and spec.get("action") == "suppress":
        return
    prev = new = None
    with _lock:
        if phase is not None and _phases:
            prev = _phases[-1]
            _phases[-1] = phase
            new = phase
        _mark = time.monotonic()
        _beats += 1
    if new is not None and new != prev:
        _emit_phase(prev, new)


def tick(phase: Optional[str] = None) -> None:
    """Record progress from inside a guarded loop; `phase` relabels the
    current guard. Outside any guard it does nothing."""
    with _lock:
        if _depth == 0:
            return
    _touch(phase)


@contextlib.contextmanager
def guard(phase: str):
    """Watch one blocking device region; entering and leaving both count
    as progress. Guards nest."""
    global _depth, _mark, _beats
    with _lock:
        prev = _phases[-1] if _phases else None
        _depth += 1
        _phases.append(phase)
        # the region opens on a fresh mark: the `hb.phase` event below is
        # an fsync'd append, host work inside the region that a loaded
        # disk can hold for longer than a short deadline, and the last
        # mark before it is the previous region's exit
        _mark = time.monotonic()
    if phase != prev:
        _emit_phase(prev, phase)
    _touch()
    try:
        yield
    finally:
        with _lock:
            _depth = max(0, _depth - 1)
            if _phases:
                _phases.pop()
            restored = _phases[-1] if _phases else None
            _mark = time.monotonic()
            _beats += 1
        if restored != phase:
            _emit_phase(phase, restored)


def snapshot() -> dict:
    """{in_flight, age_s, phase, beats}; age_s is the time since the last
    mark (0.0 before any)."""
    with _lock:
        in_flight = _depth > 0
        phase = _phases[-1] if _phases else None
        age = (time.monotonic() - _mark) if _mark is not None else 0.0
        return {"in_flight": in_flight, "age_s": age,
                "phase": phase, "beats": _beats}


def reset() -> None:
    """Clear all state (in-process tests)."""
    global _depth, _mark, _beats
    with _lock:
        _depth = 0
        _phases.clear()
        _mark = None
        _beats = 0
