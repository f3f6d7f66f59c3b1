"""Env-driven deterministic fault injection (`TPU_REDUCTIONS_FAULTS`).

The counterpart of tpu_reductions/faults/inject.py. A site calls
`fault_point("<name>")`; with the variable unset that is one lookup of
None. Set to a JSON plan (or `@/path/to/plan.json`), named points fire
scripted faults:

    TPU_REDUCTIONS_FAULTS='{"serve.batch": {"after": 1, "times": 1}}'

Plan entry fields: `after` skips the first N hits (default 0); `times`
fires at most N times (default: forever); `action` is `raise` (an
InjectedFault), `stall` (sleep `seconds`, default 3600), `spin` (the
card's stall: launch the spin kernel of csrc/fault.cu for `seconds`,
default 20, at most 30, on the run's device and return, so the next
synchronize blocks; on the CPU it raises), `exit` (os._exit(`code`),
default 1), or anything else, which has no side effect and is returned
for the caller to read (`suppress` freezes the heartbeat mark).

The port's points: `exec.launch` (exec/core.run, between the plan's
`exec.plan` event and its `exec.launch` event, before any device work),
`serve.batch` (one serving launch, serve/executor.py), `heartbeat.tick`
(every progress mark, utils/heartbeat.py), `router.crash` (each routed
submit, serve/router.py: an `exit` there is a controller death),
`drain.step` (a drain after its queue emptied, serve/autoscale.py) and
`chain.step` (each trip of chained timing, utils/timing.py, ahead of the
trip's guard: `{"action": "spin", "after": 2}` stalls the first timed
trip's graph replay). Each firing is recorded as a `fault.fire` event
before its side effect.

Counters are process-global; `reset()` re-arms them for tests.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

ENV_VAR = "TPU_REDUCTIONS_FAULTS"


class InjectedFault(RuntimeError):
    """A scripted failure from a fault point."""


_counters: Dict[str, int] = {}
_plan_cache: tuple = (None, {})   # (raw env string, parsed plan)


def reset() -> None:
    """Clear hit counters and the plan cache (in-process tests)."""
    global _plan_cache
    _counters.clear()
    _plan_cache = (None, {})


def _plan() -> dict:
    """The active plan, parsed and cached on the raw env value. A
    malformed plan raises ValueError: a chaos run that injects nothing
    would test nothing."""
    global _plan_cache
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return {}
    cached_raw, cached = _plan_cache
    if raw == cached_raw:
        return cached
    src = raw
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            src = f.read()
    try:
        plan = json.loads(src)
    except ValueError as e:
        raise ValueError(f"{ENV_VAR}: malformed fault plan: {e}") from e
    if not isinstance(plan, dict):
        raise ValueError(f"{ENV_VAR}: fault plan must be a JSON object "
                         "mapping fault-point names to specs")
    _plan_cache = (raw, plan)
    return plan


def active() -> bool:
    """Whether any fault plan is armed."""
    return bool(os.environ.get(ENV_VAR))


def _run_device():
    """The device this process runs on: the current card once torch has
    initialized CUDA, as a run on the card has by the time its fault
    points past staging fire; else the CPU."""
    import torch
    if torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fault_point(name: str) -> Optional[dict]:
    """Declare a fault point. None when it does not fire; side-effect
    actions fire here; passive specs are returned."""
    if not os.environ.get(ENV_VAR):
        return None
    spec = _plan().get(name)
    if spec is None:
        return None
    hit = _counters.get(name, 0)
    _counters[name] = hit + 1
    after = int(spec.get("after", 0))
    times = spec.get("times")
    if hit < after:
        return None
    if times is not None and hit >= after + int(times):
        return None
    action = spec.get("action", "raise")
    from tpu_reductions_torch.obs import ledger
    ledger.emit("fault.fire", point=name, action=action, hit=hit)
    if action == "raise":
        raise InjectedFault(spec.get("message",
                                     f"injected fault at {name} "
                                     f"(hit {hit})"))
    if action == "stall":
        time.sleep(float(spec.get("seconds", 3600)))
        return spec
    if action == "spin":
        from tpu_reductions_torch.ops import _cuda
        _cuda.spin_wait(float(spec.get("seconds", 20)), _run_device())
        return spec
    if action == "exit":
        os._exit(int(spec.get("code", 1)))
    return spec
