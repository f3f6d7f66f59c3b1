"""The one executor: every launch of the port's instruments and of the
serving path enters through `run(plan)`.

The counterpart of tpu_reductions/exec/core.py. It owns the heartbeat
guard (utils/heartbeat.py), the retry classification (utils/retry.py),
the compile-seam spans (`observe_compile`, obs/compile.compile_span
with its build-directory verdict) and the `exec.plan` /
`exec.launch` / `exec.done` ledger events. A plan's builder gets the
wiring only through its `LaunchContext`.

`fault_point("exec.launch")` fires between the plan's record and its
launch.

`maybe_arm` (utils/watchdog.py) is re-exported here, as the JAX core
re-exports its arming gate: entry points arm through the core.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

from tpu_reductions_torch.exec.plan import LaunchPlan
from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.utils.watchdog import maybe_arm  # noqa: F401

# compile seams already observed in this process, by the caller's key
_observed_keys: set = set()


def reset_observed() -> None:
    """Forget the once-per-key dedupe (in-process tests)."""
    _observed_keys.clear()


@contextlib.contextmanager
def observe_compile(surface: str, *, key=None, **fields):
    """Bracket one compile seam in obs/compile.compile_span: the
    `compile.start` / `compile.end` events, with the wall seconds, the
    build directory's verdict and `cache_new`, under one child trace
    span. `key`, when given, dedupes process-wide: only the first entry
    per key is observed. Yields a dict whose entries ride the end event;
    the seam's exceptions pass through, recorded as `error`."""
    if key is not None:
        if key in _observed_keys:
            yield None
            return
        _observed_keys.add(key)
    from tpu_reductions_torch.obs.compile import compile_span
    with compile_span(surface, **fields) as obs:
        yield obs


class LaunchContext:
    """The builder's only handle to the guarded and retried wiring,
    scoped to its plan's contract."""

    def __init__(self, plan: LaunchPlan) -> None:
        self.plan = plan

    def tick(self) -> None:
        """One forward-progress mark."""
        from tpu_reductions_torch.utils import heartbeat
        heartbeat.tick()

    def guard(self, phase: Optional[str] = None):
        """A heartbeat guard for builders that scope their own regions."""
        from tpu_reductions_torch.utils import heartbeat
        return heartbeat.guard(phase
                               or self.plan.contract.heartbeat_phase
                               or "device")

    def call(self, fn: Callable, *, phase: Optional[str] = None):
        """One retried, classified, guarded device unit."""
        from tpu_reductions_torch.utils.retry import retry_device_call
        return retry_device_call(
            fn, phase=(phase or self.plan.contract.heartbeat_phase
                       or "device"),
            log=self.plan.contract.retry_log)

    def observe_compile(self, surface: Optional[str] = None, *,
                        key=None, **fields):
        """This plan's compile seam; the plan's surface by default."""
        return observe_compile(surface or self.plan.surface, key=key,
                               **fields)


def run(plan: LaunchPlan):
    """Execute one LaunchPlan under its contract: `exec.plan`, the
    `exec.launch` fault point, `exec.launch`, the builder under the
    contract's guard or retry, then `exec.done` (ok, and the
    dispatch-side wall clock: an attribution number, never a rate). The
    whole launch shares one child trace span."""
    from tpu_reductions_torch.obs import ledger, trace

    c = plan.contract
    with trace.child():
        ledger.emit("exec.plan", surface=plan.surface, kind=plan.kind,
                    timing=plan.timing, phase=c.heartbeat_phase,
                    retry=bool(c.retry),
                    staging_bound=c.staging_bound,
                    drain=bool(c.drain), **plan.geometry_dict())
        fault_point("exec.launch")
        ctx = LaunchContext(plan)
        ledger.emit("exec.launch", surface=plan.surface, kind=plan.kind)
        t0 = time.monotonic()
        try:
            if c.retry:
                from tpu_reductions_torch.utils.retry import (
                    retry_device_call)
                result = retry_device_call(
                    lambda: plan.builder(ctx),
                    phase=c.heartbeat_phase or "device",
                    log=c.retry_log)
            elif c.heartbeat_phase is not None:
                from tpu_reductions_torch.utils import heartbeat
                with heartbeat.guard(c.heartbeat_phase):
                    result = plan.builder(ctx)
            else:
                result = plan.builder(ctx)
        except BaseException as e:
            ledger.emit("exec.done", surface=plan.surface,
                        kind=plan.kind, ok=False,
                        error=type(e).__name__,
                        wall_s=round(time.monotonic() - t0, 6))
            raise
        ledger.emit("exec.done", surface=plan.surface, kind=plan.kind,
                    ok=True,
                    wall_s=round(time.monotonic() - t0, 6))
    return result
