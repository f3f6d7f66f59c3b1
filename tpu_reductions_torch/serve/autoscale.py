"""The elastic fleet: the autoscaler's control loop and the drain, the
planned scale-down.

The counterpart of tpu_reductions/serve/autoscale.py. A control loop reads
signals the fleet already has (the rolling p99 of each SLO class, queued
depth, per-replica outstanding) and spawns or retires replicas behind the
ReplicaRouter under hysteresis and a cooldown (config.autoscale_min,
autoscale_max, autoscale_cooldown_s).

A planned scale-down is a drain, not a kill (`drain_replica`):

  1. admission closes (engine.begin_drain: the `replica-draining`
     refusal the router re-routes for free) and affinity stops hashing
     keys to the victim;
  2. queued and in-flight work finishes (`drain.wait`);
  3. the victim's warm bucket keys are prewarmed on the survivors that
     affinity will hash them to (`router.affinity_target`);
  4. the partial state moves to the survivors' placement through one
     planner program (reshard/planner.py), run under the declared
     peak-memory bound through BatchExecutor.run_reshard and verified
     element by element against the numpy oracle
     (reshard/oracle.verify_placement);
  5. only then does the replica stop and leave the routing table.

So a drain sheds no request where a kill sheds the victim's queue. On the
card the reshard's k ranks are rows of one tensor on the executor's
device (docs/PORT.md "The fleet on one card"); everything else here is
host code.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from tpu_reductions_torch import config
from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.obs import ledger

# handoff payload geometry: one (k, k, _HANDOFF_COLS) f32 partial a
# drain, small enough to move in milliseconds, shaped so the
# partial->sharded program has a real reduce-scatter to run (dim 0
# divisible by k for every k <= 64)
_HANDOFF_COLS = 128


def drain_replica(router, victim, *, executor=None,
                  mem_bound: float = 2.0, seed: int = 0,
                  poll_s: float = 0.02, timeout_s: float = 30.0,
                  clock: Callable[[], float] = time.monotonic) -> dict:
    """Retire `victim` from `router` by the drain protocol (module
    docstring) and return the evidence dict the elastic artifact
    commits: wait wall-clock, warm-key handoff map, and the
    oracle-verified redistribution program with its measured
    peak-memory factor vs the declared bound."""
    vid = victim.replica_id
    ledger.emit("drain.begin", replica=vid,
                mem_bound=round(float(mem_bound), 6))
    # write-ahead (serve/journal.py): the journal shows "draining"
    # before admission closes, so a controller crash mid-drain leaves
    # recovery a record of the phase — a draining-but-alive child is
    # adopted like any other and the drain re-decided
    journal = getattr(router, "journal", None)
    if journal is not None:
        journal.record_replica(vid, state="draining")
    victim.drain_begin()

    # -- 2. let in-flight + queued work finish ------------------------
    t0 = clock()
    drained = False
    while clock() - t0 < timeout_s:
        outstanding = router.load_snapshot()["outstanding"].get(vid, 0)
        queued = victim.queued_depth()
        if outstanding <= 0 and queued <= 0:
            drained = True
            break
        time.sleep(poll_s)
    waited_s = round(clock() - t0, 6)
    ledger.emit("drain.wait", replica=vid, waited_s=waited_s,
                drained=drained)

    # chaos hook: the drain's interruptible unit; a fault here is the
    # kill case the chaos tests contrast (faults/inject.py)
    fault_point("drain.step")

    # -- 3. warm bucket keys -> the survivors affinity will pick ------
    handoff: List[dict] = []
    for key in victim.warm_bucket_keys():
        method, dtype, n = key
        target = router.affinity_target(method, dtype, int(n),
                                        exclude=(vid,))
        if target is None:
            continue
        target.prewarm(method, dtype, int(n))
        handoff.append({"key": [method, dtype, int(n)],
                        "target": target.replica_id})
    ledger.emit("drain.handoff", replica=vid, keys=len(handoff),
                targets=len({h["target"] for h in handoff}))

    # -- 4. sharded partials -> survivors via a planned reshard -------
    reshard = _reshard_partials(vid, executor=executor,
                                mem_bound=mem_bound, seed=seed)

    # -- 5. only now does the replica leave ---------------------------
    victim.stop()
    router.remove_replica(vid)
    stats = _victim_stats(victim)
    ledger.emit("drain.done", replica=vid, waited_s=waited_s,
                keys=len(handoff),
                shed=int(stats.get("shed", 0)),
                expired=int(stats.get("expired", 0)),
                reshard_ok=bool(reshard and reshard.get("ok")))
    return {"replica": vid, "drained": drained, "waited_s": waited_s,
            "handoff": handoff, "reshard": reshard,
            "victim_stats": stats}


def _victim_stats(victim) -> Dict[str, float]:
    """Duck-typed terminal counters of a retired replica — the
    drain-vs-kill contract's evidence (engine.stats for LocalReplica;
    replicas without counters report empty)."""
    probe = getattr(victim, "stats", None)
    if callable(probe):
        try:
            return dict(probe())
        except (TypeError, OSError, ValueError):
            return {}
    engine = getattr(victim, "_engine", None)
    return dict(engine.stats) if engine is not None else {}


def _reshard_partials(vid: str, *, executor, mem_bound: float,
                      seed: int) -> Optional[dict]:
    """Move the victim's per-device partial state to the survivors'
    placement as ONE planner-emitted program: partial per-rank addends
    -> row-sharded (the drain's state handoff is exactly the
    reshard_curve `partial_to_row` pair), planned under the declared
    peak-memory bound, executed through the executor's device seam
    (executor.run_reshard: the ranks on min(k, C) of the executor's C
    cards, `cards` in the result), verified element-wise against the
    pure-numpy oracle. Returns None when the executor has one rank
    (nothing is sharded, nothing moves)."""
    from tpu_reductions_torch.reshard import (ShardingSpec, plan_reshard,
                                              verify_placement)
    if executor is None:
        from tpu_reductions_torch.serve.executor import BatchExecutor
        executor = BatchExecutor()
    k = int(executor.capabilities().get("device_count", 1))
    if k < 2:
        return None
    src = ShardingSpec.replicated(k, 2, partial=True)
    dst = ShardingSpec.sharded(k, 2, 0)
    shape = (k, _HANDOFF_COLS)
    plan = plan_reshard(src, dst, shape, 4, mem_bound=mem_bound)
    rng = np.random.default_rng([seed, k])
    carried = rng.standard_normal((k,) + shape).astype(np.float32)
    m_abs = float(np.abs(carried).max())
    # the partial pair's f32 psum tolerance (bench/reshard_curve.py):
    # k half-ulps at the summed magnitude
    bound = float(k) * m_abs * 2.0 ** -22
    res = executor.run_reshard(plan, carried)
    verdict = verify_placement(carried, src, dst, res["shards"],
                               atol=bound)
    mem_ok = res["measured_mem_factor"] <= plan.mem_factor + 1e-9
    ok = bool(verdict["ok"]) and mem_ok
    ledger.emit("drain.reshard", replica=vid,
                program=",".join(s.primitive for s in plan.steps),
                ranks=k, cards=res["cards"],
                wall_s=round(res["wall_s"], 6),
                mem_factor=round(plan.mem_factor, 6),
                measured_mem_factor=round(res["measured_mem_factor"], 6),
                max_err=verdict["max_err"], bound=bound, ok=ok)
    return {"ok": ok, "ranks": k, "cards": res["cards"],
            "program": [s.primitive for s in plan.steps],
            "mem_factor": round(plan.mem_factor, 6),
            "measured_mem_factor": round(res["measured_mem_factor"], 6),
            "mem_ok": mem_ok,
            "max_err": verdict["max_err"], "bound": bound,
            "wall_s": round(res["wall_s"], 6)}


class Autoscaler:
    """The control loop (module docstring): one `tick()` reads the
    fleet's signals and makes at most one scaling action, under the
    hysteresis that keeps a steady fleet steady — scale-up and
    scale-down trigger on DIFFERENT thresholds (up_load > down_load),
    scale-down additionally needs `down_ticks` consecutive calm ticks,
    and every action starts a cooldown during which no further action
    fires. Deterministic by construction (injectable clock, no
    randomness): the oscillation test drives tick() directly.

    `spawn(index)` returns a NOT-yet-started replica; the autoscaler
    starts it via router.add_replica and prewarms onto it every warm
    bucket key that now hashes to it (the scale-up twin of the drain's
    handoff — a fresh replica never serves a hot key cold)."""

    def __init__(self, router, spawn: Callable[[int], object], *,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 slo_classes: Optional[Dict[str, float]] = None,
                 executor=None, up_load: float = 4.0,
                 down_load: float = 1.0, down_ticks: int = 3,
                 mem_bound: float = 2.0, journal=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._router = router
        self._spawn = spawn
        self._min = config.autoscale_min(min_replicas)
        self._max = config.autoscale_max(max_replicas)
        self._cooldown_s = config.autoscale_cooldown_s(cooldown_s)
        if self._min < 1 or self._max < self._min:
            raise ValueError(
                f"need 1 <= min <= max, got min={self._min} "
                f"max={self._max}")
        self._slo_classes = dict(slo_classes or {})
        self._executor = executor
        self._up_load = float(up_load)
        self._down_load = float(down_load)
        self._down_ticks = int(down_ticks)
        self._mem_bound = float(mem_bound)
        self._clock = clock
        # the fleet journal, when the fleet has one: every tick's
        # control state (cooldown anchor, calm counter, last decision)
        # is journaled write-ahead so a restarted controller resumes
        # the POLICY mid-cooldown instead of cold-starting it
        # (serve/journal.py; router.journal is the usual source)
        self._journal = journal if journal is not None \
            else getattr(router, "journal", None)
        self._last_action_t: Optional[float] = None
        self._last_action: Optional[str] = None
        self._calm = 0
        self._next_idx = len(router.replicas)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.history: List[dict] = []
        self.drains: List[dict] = []

    # -- crash-consistent control state (serve/journal.py) ------------

    def export_state(self) -> dict:
        """The journal-shaped control-loop state. The cooldown anchor
        crosses processes as a WALL clock (`time.time()`): the dead
        controller's monotonic clock means nothing to the successor,
        but wall-clock elapsed-since-last-action does."""
        if self._last_action_t is None:
            last_wall = None
        else:
            last_wall = time.time() - (self._clock()
                                       - self._last_action_t)
        return {"last_action_wall": last_wall,
                "last_action": self._last_action,
                "cooldown_s": self._cooldown_s,
                "calm": self._calm, "next_idx": self._next_idx}

    def restore_state(self, state: Optional[dict]) -> None:
        """Resume a journaled control loop mid-cooldown: the remaining
        cooldown carries over (converted back onto this process's
        clock), as do the calm-tick counter and the replica-name
        counter — the successor never re-fires a decision the
        predecessor's hysteresis had already damped."""
        if not state:
            return
        last_wall = state.get("last_action_wall")
        if last_wall is not None:
            elapsed = max(0.0, time.time() - float(last_wall))
            self._last_action_t = self._clock() - elapsed
        self._last_action = state.get("last_action")
        self._calm = int(state.get("calm") or 0)
        self._next_idx = max(self._next_idx,
                             int(state.get("next_idx") or 0))
        ledger.emit("autoscale.resume",
                    cooling=(self._last_action_t is not None
                             and self._clock() - self._last_action_t
                             < self._cooldown_s),
                    calm_ticks=self._calm, next_idx=self._next_idx)

    # -- signals ------------------------------------------------------

    def _signals(self) -> dict:
        snap = self._router.load_snapshot()
        active = [r["replica"] for r in snap["replicas"]
                  if r["alive"] and not r["draining"]]
        queued = 0
        worst_p99 = None
        breach = False
        for rep in self._router.replicas:
            if rep.replica_id not in active:
                continue
            probe = getattr(rep, "queued_depth", None)
            if callable(probe):
                queued += int(probe() or 0)
            for slo, deadline in self._slo_classes.items():
                p99_fn = getattr(rep, "slo_p99", None)
                p99 = p99_fn(slo) if callable(p99_fn) else None
                if p99 is None:
                    continue
                if worst_p99 is None or p99 > worst_p99:
                    worst_p99 = p99
                if deadline is not None and p99 > deadline:
                    breach = True
        outstanding = sum(snap["outstanding"].get(r, 0) for r in active)
        load = (outstanding + queued) / max(1, len(active))
        return {"replicas": len(active), "outstanding": outstanding,
                "queued": queued, "load_per_replica": round(load, 4),
                "p99_worst": worst_p99, "p99_breach": breach,
                "active": active}

    # -- the loop body ------------------------------------------------

    def tick(self) -> dict:
        """One control-loop step: observe -> (maybe) act -> record.
        Returns the tick record (also appended to `history` — the
        replica-count-vs-load trajectory the elastic artifact
        commits)."""
        now = self._clock()
        sig = self._signals()
        n = sig["replicas"]
        cooling = (self._last_action_t is not None
                   and now - self._last_action_t < self._cooldown_s)
        want_up = (sig["load_per_replica"] > self._up_load
                   or sig["p99_breach"])
        calm = (sig["load_per_replica"] < self._down_load
                and not sig["p99_breach"])
        self._calm = self._calm + 1 if calm else 0
        action = "hold"
        if want_up and n < self._max and not cooling:
            # write-ahead: the decision (and the cooldown it starts)
            # is on disk before the spawn, so a crash mid-action
            # resumes cooling instead of immediately re-deciding
            self._last_action_t = now
            self._last_action = "up"
            self._calm = 0
            self._journal_state()
            self._scale_up(sig)
            action = "up"
        elif (self._calm >= self._down_ticks and n > self._min
                and not cooling):
            self._last_action_t = now
            self._last_action = "down"
            self._calm = 0
            self._journal_state()
            self._scale_down(sig)
            action = "down"
        else:
            self._journal_state()
        record = dict(sig, action=action, cooling=cooling,
                      calm_ticks=self._calm, t=round(now, 4))
        record.pop("active")
        ledger.emit("autoscale.tick", **record)
        self.history.append(record)
        return record

    def _journal_state(self) -> None:
        if self._journal is not None:
            self._journal.record_autoscaler(self.export_state())

    def _scale_up(self, sig: dict) -> None:
        replica = self._spawn(self._next_idx)
        self._next_idx += 1
        self._router.add_replica(replica)
        # the scale-up handoff: every warm key that NOW hashes to the
        # newcomer gets prewarmed there before traffic finds it cold
        warmed = 0
        seen = set()
        for rep in self._router.replicas:
            if rep.replica_id == replica.replica_id:
                continue
            probe = getattr(rep, "warm_bucket_keys", None)
            if not callable(probe):
                continue
            for key in probe():
                if key in seen:
                    continue
                seen.add(key)
                method, dtype, kn = key
                target = self._router.affinity_target(
                    method, dtype, int(kn))
                if target is not None \
                        and target.replica_id == replica.replica_id:
                    replica.prewarm(method, dtype, int(kn))
                    warmed += 1
        ledger.emit("autoscale.up", replica=replica.replica_id,
                    replicas=sig["replicas"] + 1,
                    load_per_replica=sig["load_per_replica"],
                    p99_breach=sig["p99_breach"], prewarmed=warmed)

    def _scale_down(self, sig: dict) -> None:
        # deterministic victim: the newest active replica (LIFO) —
        # the oldest replicas hold the longest-lived affinity history
        victim = None
        for rep in reversed(self._router.replicas):
            if rep.replica_id in sig["active"]:
                victim = rep
                break
        if victim is None:
            return
        evidence = drain_replica(self._router, victim,
                                 executor=self._executor,
                                 mem_bound=self._mem_bound,
                                 clock=self._clock)
        self.drains.append(evidence)
        ledger.emit("autoscale.down", replica=victim.replica_id,
                    replicas=sig["replicas"] - 1,
                    load_per_replica=sig["load_per_replica"],
                    shed=int(evidence["victim_stats"].get("shed", 0)))

    # -- optional background loop (the CLI/loadgen harness) -----------

    def start(self, interval_s: float = 0.25) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                self.tick()
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
