"""LaunchPlan: the frozen description of one launch.

The counterpart of tpu_reductions/exec/plan.py, with the same validation
and words. A plan is a value: the builder to run, the surface it belongs
to, its timing doctrine, and the resilience contract the executor
(exec/core.py) honours around it. Building one touches no device.

The builder receives a `core.LaunchContext`, its only handle to the
guarded and retried wiring: `ctx.call(fn)`, `ctx.guard(phase)`,
`ctx.tick()`, `ctx.observe_compile(...)`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

# the timing doctrines a plan can declare
TIMING_MODES = ("chained", "stream", "serve", "steps")

# plan kinds: one per device-touching path
PLAN_KINDS = ("chain", "stream", "serve", "collective", "reshard",
              "bench")


@dataclasses.dataclass(frozen=True)
class ResilienceContract:
    """What the executor owes the plan.

    heartbeat_phase  the label of the guard around the whole builder
                     (None: the builder scopes its own guards through
                     `ctx.guard` / `ctx.call`)
    retry            wrap the whole builder in the bounded retry
                     (utils/retry.py classification)
    staging_bound    the largest host-to-device copy the plan may make
                     (None: config.stage_chunk_bytes; informational)
    drain            the plan leaves no device work in flight on exit
    retry_log        where retry attempts are narrated (identity, not
                     plan semantics)
    """

    heartbeat_phase: Optional[str] = "device"
    retry: bool = False
    staging_bound: Optional[int] = None
    drain: bool = False
    retry_log: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch, described and not performed.

    surface    the compile-seam id the launch belongs to; the `exec.*`
               events carry it
    kind       which path produced it (PLAN_KINDS)
    timing     its timing doctrine (TIMING_MODES)
    builder    `builder(ctx) -> result`: the work itself
    contract   the resilience contract
    geometry   hashable (key, value) pairs of the launch's shape, stamped
               onto the exec.plan event and never read by the executor
    """

    surface: str
    kind: str
    builder: Callable = dataclasses.field(repr=False, compare=False,
                                          default=None)
    timing: str = "chained"
    contract: ResilienceContract = dataclasses.field(
        default_factory=ResilienceContract)
    geometry: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.kind not in PLAN_KINDS:
            raise ValueError(f"unknown plan kind {self.kind!r}; one of "
                             f"{PLAN_KINDS}")
        if self.timing not in TIMING_MODES:
            raise ValueError(f"unknown timing mode {self.timing!r}; "
                             f"one of {TIMING_MODES}")
        if self.builder is None:
            raise ValueError("a LaunchPlan needs a builder")

    def geometry_dict(self) -> Dict[str, Any]:
        return dict(self.geometry)


def launch_plan(surface: str, kind: str, builder: Callable, *,
                timing: str = "chained",
                heartbeat_phase: Optional[str] = "device",
                retry: bool = False,
                staging_bound: Optional[int] = None,
                drain: bool = False,
                retry_log: Optional[Callable] = None,
                **geometry) -> LaunchPlan:
    """Keyword constructor: the geometry kwargs become the frozen (key,
    value) tuple, sorted for a stable event row."""
    return LaunchPlan(
        surface=surface, kind=kind, builder=builder, timing=timing,
        contract=ResilienceContract(heartbeat_phase=heartbeat_phase,
                                    retry=retry,
                                    staging_bound=staging_bound,
                                    drain=drain, retry_log=retry_log),
        geometry=tuple(sorted(geometry.items())))


def device_task(surface: str, fn: Callable, *, kind: str = "bench",
                timing: str = "chained",
                heartbeat_phase: Optional[str] = "device",
                retry_log: Optional[Callable] = None,
                **geometry) -> LaunchPlan:
    """The whole-task plan of the instruments (spot, smoke, autotune,
    sweep, firstrow): one retried, classified unit wrapping `fn()`."""
    return launch_plan(surface, kind, lambda ctx: fn(), timing=timing,
                       heartbeat_phase=heartbeat_phase, retry=True,
                       retry_log=retry_log, **geometry)
