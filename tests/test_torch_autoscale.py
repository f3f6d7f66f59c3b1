"""The port's autoscaler and drain against the JAX package's, on the CPU:
the autoscaler's decisions over the same signal sequences (scale-up under
load and its cooldown, the hysteresis gap, scale-down after consecutive
calm ticks, an interrupted calm run, a p99 breach at zero load, the
bounds), its journaled state across export and restore, the drain
shedding no request with the same handoff targets where a kill sheds the
victim's queue, the `drain.step` fault, and `_reshard_partials` on eight
ranks (the port's rows of one tensor, JAX's eight virtual CPU devices)
oracle-verified under the same memory bound, with the same program,
factors and error."""

import threading
import time
import types
import zlib

import pytest

from tpu_reductions import config as jax_config
from tpu_reductions.faults import inject as jax_inject
from tpu_reductions.serve import autoscale as jax_autoscale
from tpu_reductions.serve import engine as jax_engine
from tpu_reductions.serve import executor as jax_executor
from tpu_reductions.serve import request as jax_request
from tpu_reductions.serve import router as jax_router
from tpu_reductions_torch import config as port_config
from tpu_reductions_torch.faults import inject as port_inject
from tpu_reductions_torch.serve import autoscale as port_autoscale
from tpu_reductions_torch.serve import engine as port_engine
from tpu_reductions_torch.serve import executor as port_executor
from tpu_reductions_torch.serve import request as port_request
from tpu_reductions_torch.serve import router as port_router

SIDES = {
    "jax": types.SimpleNamespace(
        autoscale=jax_autoscale, engine=jax_engine, request=jax_request,
        router=jax_router, inject=jax_inject, extra={},
        executor=lambda: jax_executor.BatchExecutor()),
    "port": types.SimpleNamespace(
        autoscale=port_autoscale, engine=port_engine, request=port_request,
        router=port_router, inject=port_inject, extra={"platform": "cpu"},
        executor=lambda: port_executor.BatchExecutor("cpu", ranks=8)),
}


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    monkeypatch.delenv("TPU_REDUCTIONS_FAULTS", raising=False)
    monkeypatch.delenv("TPU_REDUCTIONS_LEDGER", raising=False)
    for name in ("TPU_REDUCTIONS_AUTOSCALE_MIN",
                 "TPU_REDUCTIONS_AUTOSCALE_MAX",
                 "TPU_REDUCTIONS_AUTOSCALE_COOLDOWN_S",
                 "TPU_REDUCTIONS_FLEET_JOURNAL"):
        monkeypatch.delenv(name, raising=False)
    jax_inject.reset()
    port_inject.reset()
    yield
    jax_inject.reset()
    port_inject.reset()


class FakeExecutor:
    """A device stand-in (one rank: no reshard); results are seeds."""

    def __init__(self, hold=None):
        self.hold = hold
        self.launches = []

    def capabilities(self):
        return {"backend": "cpu", "supports_f64": True, "device_count": 1}

    def run_batch(self, method, dtype, n, seeds):
        self.launches.append((method, dtype, n, tuple(seeds)))
        if self.hold is not None:
            assert self.hold.wait(timeout=30)
        return [{"result": float(s), "ok": True, "host": float(s),
                 "diff": 0.0} for s in seeds]


def _affine_n(idx, n_alive, method="SUM", dtype="int32", start=64):
    n = start
    while zlib.crc32(f"{method}:{dtype}:{n}".encode()) % n_alive != idx:
        n += 1
    return n


# ---------------------------------------------------------- the knobs

@pytest.mark.parametrize("env,override", [
    ({}, None), ({"MIN": "2", "MAX": "5", "COOLDOWN_S": "0.5"}, None),
    ({"MIN": "2"}, 3), ({"COOLDOWN_S": "-1"}, None),
    ({"MAX": "x"}, None), ({}, 0)])
def test_fleet_knobs_match_jax(monkeypatch, env, override):
    for k, v in env.items():
        monkeypatch.setenv(f"TPU_REDUCTIONS_AUTOSCALE_{k}", v)
    for fn in ("autoscale_min", "autoscale_max", "autoscale_cooldown_s"):
        assert getattr(port_config, fn)(override) == \
            getattr(jax_config, fn)(override), fn
    monkeypatch.setenv("TPU_REDUCTIONS_FLEET_JOURNAL", "/j.json")
    assert port_config.fleet_journal_path() == \
        jax_config.fleet_journal_path() == "/j.json"
    assert port_config.fleet_journal_path("x") == "x"


# ------------------------------------------------ the control loop

class _FakeRep:
    def __init__(self, rid, fleet):
        self.replica_id = rid
        self._fleet = fleet

    def start(self):
        return self

    def alive(self):
        return True

    def draining(self):
        return False

    def queued_depth(self):
        return self._fleet.queued

    def slo_p99(self, slo):
        return self._fleet.p99

    def warm_bucket_keys(self):
        return []

    def prewarm(self, method, dtype, n, **kw):
        pass

    def drain_begin(self):
        pass

    def stop(self):
        pass

    def stats(self):
        return {}


class _FakeFleet:
    """A router stand-in with dial-a-load signals."""

    def __init__(self, n):
        self._reps = [_FakeRep(f"f{i}", self) for i in range(n)]
        self.outstanding = 0
        self.queued = 0
        self.p99 = None
        self.journal = None

    @property
    def replicas(self):
        return list(self._reps)

    def load_snapshot(self):
        return {"outstanding": {r.replica_id: self.outstanding
                                for r in self._reps},
                "stats": {},
                "replicas": [{"replica": r.replica_id, "alive": True,
                              "draining": False} for r in self._reps]}

    def add_replica(self, rep):
        self._reps.append(rep)

    def remove_replica(self, rid):
        self._reps = [r for r in self._reps if r.replica_id != rid]

    def affinity_target(self, method, dtype, n, exclude=()):
        alive = [r for r in self._reps if r.replica_id not in exclude]
        return alive[0] if alive else None


# each script: (start replicas, scaler kwargs, [(dt, outstanding, queued,
# p99) per tick])
SCRIPTS = {
    "up-cooldown-max": (1, {}, [(0, 10, 0, None), (1, 10, 0, None),
                                (10, 10, 0, None), (11, 10, 0, None),
                                (1, 10, 0, None)]),
    "hysteresis-gap": (2, {}, [(10, 1, 0, None)] * 12),
    "calm-down-floor": (2, {}, [(0, 0, 0, None)] * 3
                        + [(100, 0, 0, None)] * 5),
    "interrupted-calm": (2, {}, [(0, 0, 0, None), (0, 0, 0, None),
                                 (0, 1, 0, None), (0, 0, 0, None),
                                 (0, 0, 0, None), (0, 0, 0, None)]),
    "queued-load": (1, {"up_load": 2.0}, [(0, 0, 3, None),
                                          (20, 0, 1, None)]),
    "p99-breach": (1, {"slo_classes": {"std": 0.2}},
                   [(0, 0, 0, 0.5), (20, 0, 0, 0.1), (20, 0, 0, None)]),
    "down-ticks-1": (3, {"down_ticks": 1, "cooldown_s": 0.0},
                     [(1, 0, 0, None)] * 4),
}


def _run_script(side, name):
    start, kw, ticks = SCRIPTS[name]
    fleet = _FakeFleet(start)
    t = [100.0]
    kw = {"min_replicas": 1, "max_replicas": 3, "cooldown_s": 10.0,
          "down_ticks": 3, **kw}
    auto = side.autoscale.Autoscaler(
        fleet, lambda i: _FakeRep(f"s{i}", fleet), executor=FakeExecutor(),
        clock=lambda: t[0], **kw)
    out = []
    for dt, outstanding, queued, p99 in ticks:
        t[0] += dt
        fleet.outstanding, fleet.queued, fleet.p99 = outstanding, queued, p99
        rec = auto.tick()
        out.append((rec["action"], rec["replicas"], rec["cooling"],
                    rec["calm_ticks"], rec["load_per_replica"],
                    rec["p99_breach"], len(fleet.replicas)))
    return out, [r.replica_id for r in fleet.replicas], len(auto.drains), \
        auto.export_state()["next_idx"]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_autoscaler_decides_like_jax_over_the_same_signals(name):
    got = {k: _run_script(side, name) for k, side in SIDES.items()}
    assert got["port"] == got["jax"]
    actions = [a for a, *_ in got["port"][0]]
    if name == "hysteresis-gap":
        assert set(actions) == {"hold"}
    if name == "up-cooldown-max":
        assert actions == ["up", "hold", "up", "hold", "hold"]


def test_autoscaler_bounds_are_refused_like_jax():
    msgs = []
    for side in SIDES.values():
        fleet = _FakeFleet(1)
        with pytest.raises(ValueError) as e:
            side.autoscale.Autoscaler(fleet, lambda i: None,
                                      min_replicas=4, max_replicas=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_autoscaler_state_survives_restore_like_jax():
    """export_state carries the cooldown as a wall clock; restore puts it
    back on the successor's clock, in both packages and across them."""
    class StubRouter:
        replicas = []
        journal = None

    states = {}
    for name, side in SIDES.items():
        clock = [100.0]
        a1 = side.autoscale.Autoscaler(StubRouter(), spawn=lambda i: None,
                                       cooldown_s=60.0,
                                       clock=lambda: clock[0])
        a1._last_action_t, a1._last_action = clock[0], "up"
        a1._calm, a1._next_idx = 2, 5
        states[name] = a1.export_state()
    for s in states.values():
        s.pop("last_action_wall")
    assert states["port"] == states["jax"]
    for writer, reader in (("jax", "port"), ("port", "jax")):
        clock = [500.0]
        w = SIDES[writer].autoscale.Autoscaler(
            StubRouter(), spawn=lambda i: None, cooldown_s=60.0,
            clock=lambda: clock[0])
        w._last_action_t, w._calm, w._next_idx = clock[0], 2, 5
        r = SIDES[reader].autoscale.Autoscaler(
            StubRouter(), spawn=lambda i: None, cooldown_s=60.0,
            clock=lambda: clock[0])
        r.restore_state(w.export_state())
        assert clock[0] - r._last_action_t < 5.0
        assert (r._calm, r._next_idx) == (2, 5)
    fresh = port_autoscale.Autoscaler(StubRouter(), spawn=lambda i: None)
    fresh.restore_state(None)
    assert fresh._last_action_t is None


def test_autoscaler_journals_each_tick():
    from tpu_reductions_torch.serve.journal import FleetJournal
    fleet = _FakeFleet(1)
    fleet.journal = FleetJournal(None)
    t = [0.0]
    auto = port_autoscale.Autoscaler(
        fleet, lambda i: _FakeRep(f"s{i}", fleet), executor=FakeExecutor(),
        clock=lambda: t[0], cooldown_s=10.0, max_replicas=3)
    fleet.outstanding = 10
    auto.tick()
    # write-ahead: the decision is journaled before the spawn it starts
    st = fleet.journal.autoscaler_state()
    assert st["last_action"] == "up" and st["calm"] == 0
    assert st["next_idx"] == 1 and len(fleet.replicas) == 2


def test_autoscaler_loop_starts_and_stops():
    fleet = _FakeFleet(1)
    auto = port_autoscale.Autoscaler(
        fleet, lambda i: _FakeRep(f"s{i}", fleet), executor=FakeExecutor(),
        cooldown_s=0.0)
    auto.start(interval_s=0.01)
    time.sleep(0.1)
    auto.stop()
    assert len(auto.history) >= 2
    assert {r["action"] for r in auto.history} == {"hold"}


# --------------------------------------------------- drain versus kill

def _pair(side, hold=None, max_retries=2):
    ex_s, ex_v = FakeExecutor(), FakeExecutor(hold=hold)
    surv = side.router.LocalReplica("survivor", side.engine.ServeEngine(
        executor=ex_s, coalesce_window_s=0.0, **side.extra))
    victim = side.router.LocalReplica("victim", side.engine.ServeEngine(
        executor=ex_v, coalesce_window_s=0.0, **side.extra))
    router = side.router.ReplicaRouter([surv, victim],
                                       max_retries=max_retries).start()
    return router, victim, surv, ex_v, ex_s


def _drain_scenario(side):
    """Drain mid-burst: the in-flight and queued requests finish on the
    victim, its warm key lands prewarmed on the survivor, and it leaves
    the routing table only after."""
    hold = threading.Event()
    router, victim, surv, ex_v, ex_s = _pair(side, hold=hold)
    req = side.request.ReduceRequest
    try:
        n = _affine_n(1, 2)
        first = router.submit(req(method="SUM", dtype="int32", n=n))
        time.sleep(0.1)
        rest = [router.submit(req(method="SUM", dtype="int32", n=n,
                                  seed=i)) for i in range(1, 5)]
        evidence = {}
        t = threading.Thread(target=lambda: evidence.update(
            side.autoscale.drain_replica(router, victim,
                                         executor=FakeExecutor())))
        t.start()
        time.sleep(0.2)
        waiting = t.is_alive()
        hold.set()
        t.join(timeout=30)
        statuses = [p.result(30).status for p in [first] + rest]
        return (waiting, statuses, evidence["drained"],
                evidence["victim_stats"]["shed"],
                evidence["victim_stats"]["expired"], evidence["reshard"],
                sorted(tuple(h["key"]) + (h["target"],)
                       for h in evidence["handoff"]),
                sorted(surv._engine.warm_bucket_keys()),
                [r.replica_id for r in router.replicas],
                router.stats["rerouted"])
    finally:
        hold.set()
        router.stop()


def test_drain_sheds_nothing_with_the_jax_handoff():
    out = _both(_drain_scenario)
    waiting, statuses, drained, shed, expired, reshard, handoff = out[:7]
    assert waiting and drained and statuses == ["ok"] * 5
    assert (shed, expired, reshard) == (0, 0, None)
    assert ("SUM", "int32", _affine_n(1, 2), "survivor") in handoff
    assert out[8] == ["survivor"] and out[9] == 0


def _kill_scenario(side):
    hold = threading.Event()
    router, victim, surv, ex_v, ex_s = _pair(side, hold=hold)
    req = side.request.ReduceRequest
    try:
        n = _affine_n(1, 2)
        first = router.submit(req(method="SUM", dtype="int32", n=n))
        time.sleep(0.1)
        rest = [router.submit(req(method="SUM", dtype="int32", n=n,
                                  seed=i)) for i in range(1, 5)]
        queued = victim.queued_depth()
        t = threading.Thread(target=victim.kill)
        t.start()
        time.sleep(0.1)
        shed = victim.stats()["shed"]
        hold.set()
        t.join(timeout=30)
        statuses = [p.result(30).status for p in [first] + rest]
        return queued, shed, statuses, router.stats["rerouted"] >= shed
    finally:
        hold.set()
        router.stop()


def test_kill_sheds_the_queue_where_a_drain_does_not_like_jax():
    queued, shed, statuses, rerouted = _both(_kill_scenario)
    assert queued > 0 and shed > 0 and rerouted
    assert statuses == ["ok"] * 5


def _both(scenario, *args):
    got = {name: scenario(side, *args) for name, side in SIDES.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def test_drain_step_fault_aborts_the_drain_like_jax(monkeypatch):
    monkeypatch.setenv("TPU_REDUCTIONS_FAULTS",
                       '{"drain.step": {"action": "raise"}}')
    out = {}
    for name, side in SIDES.items():
        side.inject.reset()
        router, victim, *_ = _pair(side)
        try:
            with pytest.raises(side.inject.InjectedFault) as e:
                side.autoscale.drain_replica(router, victim,
                                             executor=FakeExecutor())
            out[name] = (str(e.value),
                         [r.replica_id for r in router.replicas])
        finally:
            side.inject.reset()
            router.stop()
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["survivor", "victim"]


# ------------------------------------------------ the partial handoff

@pytest.mark.parametrize("seed,mem_bound", [(3, 2.0), (0, 1.5), (11, 4.0)])
def test_reshard_partials_match_jax_under_the_memory_bound(seed, mem_bound):
    """The drain's partial -> row-sharded program on eight ranks: the
    same program, declared and measured memory factors and oracle error
    as JAX's, verified and at or under the bound."""
    got = {name: side.autoscale._reshard_partials(
        "victim", executor=side.executor(), mem_bound=mem_bound, seed=seed)
        for name, side in SIDES.items()}
    for res in got.values():
        res.pop("wall_s")
    assert got["port"] == got["jax"]
    res = got["port"]
    assert res["ok"] is True and res["ranks"] == 8 and res["program"]
    assert res["mem_ok"] is True
    assert res["measured_mem_factor"] <= res["mem_factor"] <= mem_bound
    assert res["max_err"] <= res["bound"]


def test_one_rank_has_nothing_to_reshard():
    assert port_autoscale._reshard_partials(
        "v", executor=port_executor.BatchExecutor("cpu"), mem_bound=2.0,
        seed=0) is None


def test_run_reshard_returns_the_placed_shards():
    from tpu_reductions_torch.reshard import (ShardingSpec, plan_reshard,
                                              verify_placement)
    import numpy as np
    src = ShardingSpec.replicated(4, 2, partial=True)
    dst = ShardingSpec.sharded(4, 2, 0)
    plan = plan_reshard(src, dst, (4, 128), 4, mem_bound=2.0)
    carried = np.random.default_rng(0).standard_normal(
        (4, 4, 128)).astype(np.float32)
    ex = port_executor.BatchExecutor("cpu", ranks=4)
    res = ex.run_reshard(plan, carried)
    assert len(res["shards"]) == 4
    assert verify_placement(carried, src, dst, res["shards"],
                            atol=1e-5)["ok"]
    assert res["device_mem_factor"] is None      # the CPU has no allocator
