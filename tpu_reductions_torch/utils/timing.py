"""Timing: a stopwatch, the reference's synced timed loop, and slope timing
of a chained reduction.

The counterpart of tpu_reductions/utils/timing.py. `time.perf_counter`
around `torch.cuda.synchronize()` at the timer edges (where the JAX
package uses `block_until_ready`): PyTorch returns before the card
finishes, so a timer without the sync measures the enqueue. Chained
timing replays one CUDA graph a trip (ops/chain.py), so its slope holds
the card's time of an iteration and not the host's.

Flight recorder and watchdog, as in JAX: the synced loops run under a
heartbeat guard labelled with their mode and tick once an iteration; each
chained trip runs under its own guard (the first one, which captures the
graph, in the long-deadline `compile` phase) after the `chain.step`
fault point. The events (`timing.loop`, `chain.trip`, `chain.slope`) are
emitted after the perf_counter windows close, never inside them.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.obs import ledger, trace
from tpu_reductions_torch.utils import heartbeat


@dataclass
class Stopwatch:
    """Accumulating stopwatch: total over sessions, mean per session
    (cutGetAverageTimerValue), median of the booked samples."""

    total_s: float = 0.0
    sessions: int = 0
    samples: list = field(default_factory=list)
    _t0: Optional[float] = field(default=None, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("stopwatch stopped without start")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.total_s += dt
        self.sessions += 1
        self.samples.append(dt)
        return dt

    @property
    def average_s(self) -> float:
        return self.total_s / self.sessions if self.sessions else 0.0

    @property
    def median_s(self) -> float:
        """Median of the per-session samples; the mean when sessions were
        not booked one by one (bulk mode)."""
        if not self.samples:
            return self.average_s
        return statistics.median(self.samples)


def _materialize(result) -> None:
    """Bring a result to the host (a device tensor, or a host scalar)."""
    if hasattr(result, "cpu"):
        result.cpu()


def time_fn(fn: Callable, *args, sync: Callable[[], None],
            iterations: int = 100, warmup: int = 1,
            mode: str = "periter"):
    """Time `fn(*args)` after `warmup` untimed calls, with `sync()` at the
    timer edges. Modes (all report seconds per iteration):
      periter  sync around every call: the reference's loop structure;
      bulk     one span around all calls, one final sync;
      fetch    per call, and the result brought to the host each time.
    Returns (last_result, stopwatch)."""
    if mode not in ("periter", "bulk", "fetch"):
        raise ValueError(f"unknown timing mode {mode!r}")
    sw = Stopwatch()
    result = None
    for _ in range(warmup):
        result = fn(*args)
        sync()

    if mode == "bulk":
        # redlint: disable=RED025 -- reference-analog bulk span; the single synchronize at its edge is the instrument
        with heartbeat.guard(mode):
            sw.start()
            for _ in range(iterations):
                result = fn(*args)
            sync()
            sw.stop()
        # one span booked as `iterations` sessions; it is no per-call
        # sample, so median_s falls back to the mean
        sw.sessions += iterations - 1
        sw.samples.pop()
        return result, sw

    # redlint: disable=RED025 -- reference-analog periter/fetch loop; per-iteration synchronize edges are the measurement, not a launch plan
    with heartbeat.guard(mode):
        for _ in range(iterations):
            sw.start()
            result = fn(*args)
            sync()
            if mode == "fetch":
                _materialize(result)
            sw.stop()
            heartbeat.tick()
    ledger.emit("timing.loop", mode=mode, iterations=iterations,
                avg_s=round(sw.average_s, 9))
    return result, sw


def time_chained(chained_fn: Callable, x, k_lo: int, k_hi: int,
                 reps: int = 5) -> Stopwatch:
    """Slope timing of `chained_fn(x, k)` (ops/chain.py): time it to host
    materialization at two trip counts and book
    (t(k_hi) - t(k_lo)) / (k_hi - k_lo) as one sample per rep. Every
    constant cost (the graph's launch, the copy of its input, the final
    copy) appears in both and cancels. The two untimed warm-up trips
    capture the chain's CUDA graphs on the card, as the JAX package's
    compile its program."""
    if not k_lo < k_hi:
        raise ValueError(f"need k_lo < k_hi, got {k_lo} >= {k_hi}")
    sw = Stopwatch()
    span = k_hi - k_lo
    trips = 0

    def run(k: int) -> float:
        nonlocal trips
        fault_point("chain.step")
        phase = heartbeat.PHASE_COMPILE if trips == 0 else "chained"
        trips += 1
        # redlint: disable=RED025 -- time_chained's trip: its guard edges bracket exactly the timed graph replays (compile-tolerant on the first trip), the measured contract rather than a launch plan
        with heartbeat.guard(phase):
            t0 = time.perf_counter()
            _materialize(chained_fn(x, k))
            dt = time.perf_counter() - t0
        ledger.emit("chain.trip", k=int(k), trip=trips,
                    dur_s=round(dt, 9), phase=phase)
        return dt

    # one span per chained measurement: the trips and slopes nest under it
    with trace.child():
        run(k_lo)   # warm-up: the graphs' capture
        run(k_hi)
        for rep in range(reps):
            slope = (run(k_hi) - run(k_lo)) / span
            sw.total_s += slope
            sw.sessions += 1
            sw.samples.append(slope)
            ledger.emit("chain.slope", rep=rep, slope_s=round(slope, 12))
    return sw
