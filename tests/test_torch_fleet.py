"""The port's replica router, fleet journal, chaos relay and relay gate
against the JAX package's, on the CPU: the affinity picks for a seeded key
set, balance, re-routing on a replica's death, the draining skip and the
free draining re-route, the no-alive-replica resolution, the failure
vocabulary, a journal written by each package and replayed by the other,
adopt_fleet's stale and dead verdicts, FakeRelay and RelayTransport
delaying and dropping alike, a ProcessReplica tier surviving a kill
(--platform=cpu), and the router-crash recovery end to end.

Each scenario runs once through each package (a `side`) with a stand-in
executor, so that both routers see the same engines' behaviour, and the
observable outcomes must be equal. Every subprocess wait has a timeout."""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import zlib
from pathlib import Path

import pytest

from tpu_reductions.faults import inject as jax_inject
from tpu_reductions.faults import relay as jax_relay
from tpu_reductions.faults.schedule import Phase as JaxPhase
from tpu_reductions.serve import engine as jax_engine
from tpu_reductions.serve import journal as jax_journal
from tpu_reductions.serve import loadgen as jax_loadgen
from tpu_reductions.serve import request as jax_request
from tpu_reductions.serve import router as jax_router
from tpu_reductions.serve import transport as jax_transport
from tpu_reductions_torch.faults import inject as port_inject
from tpu_reductions_torch.faults import relay as port_relay
from tpu_reductions_torch.faults.schedule import Phase
from tpu_reductions_torch.serve import engine as port_engine
from tpu_reductions_torch.serve import journal as port_journal
from tpu_reductions_torch.serve import loadgen as port_loadgen
from tpu_reductions_torch.serve import request as port_request
from tpu_reductions_torch.serve import router as port_router
from tpu_reductions_torch.serve import transport as port_transport

REPO = Path(__file__).resolve().parents[1]

SIDES = {
    "jax": types.SimpleNamespace(
        name="jax", engine=jax_engine, request=jax_request,
        router=jax_router, journal=jax_journal, relay=jax_relay,
        Phase=JaxPhase, transport=jax_transport, loadgen=jax_loadgen,
        inject=jax_inject, extra={}),
    "port": types.SimpleNamespace(
        name="port", engine=port_engine, request=port_request,
        router=port_router, journal=port_journal, relay=port_relay,
        Phase=Phase, transport=port_transport, loadgen=port_loadgen,
        inject=port_inject, extra={"platform": "cpu"}),
}


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    monkeypatch.delenv("TPU_REDUCTIONS_FAULTS", raising=False)
    monkeypatch.delenv("TPU_REDUCTIONS_LEDGER", raising=False)
    jax_inject.reset()
    port_inject.reset()
    yield
    jax_inject.reset()
    port_inject.reset()


class FakeExecutor:
    """A device stand-in shared by both sides: each request's result is
    its seed, `hold` blocks a launch until set, `delay_s` slows it."""

    def __init__(self, delay_s=0.0, hold=None):
        self.delay_s = delay_s
        self.hold = hold
        self.launches = []

    def capabilities(self):
        return {"backend": "cpu", "supports_f64": True, "device_count": 1}

    def run_batch(self, method, dtype, n, seeds):
        self.launches.append((method, dtype, n, tuple(seeds)))
        if self.hold is not None:
            assert self.hold.wait(timeout=30)
        if self.delay_s:
            time.sleep(self.delay_s)
        return [{"result": float(s), "ok": True, "host": float(s),
                 "diff": 0.0} for s in seeds]


def _replicas(side, n, **executor_kw):
    exs = [FakeExecutor(**executor_kw) for _ in range(n)]
    reps = [side.router.LocalReplica(
        f"r{i}", side.engine.ServeEngine(executor=exs[i],
                                         coalesce_window_s=0.0,
                                         **side.extra))
        for i in range(n)]
    return reps, exs


def _affine_n(idx, n_alive, method="SUM", dtype="int32", start=64):
    """The smallest n >= start whose bucket key hashes to alive index
    `idx` (the routers' crc32)."""
    n = start
    while zlib.crc32(f"{method}:{dtype}:{n}".encode()) % n_alive != idx:
        n += 1
    return n


def _both(scenario, *args):
    """The scenario's outcome on each side; they must be equal."""
    got = {name: scenario(side, *args) for name, side in SIDES.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


# ------------------------------------------------------------ routing

class _Stub:
    def __init__(self, rid, alive=True, draining=False):
        self.replica_id = rid
        self._alive = alive
        self._draining = draining

    def alive(self):
        return self._alive

    def draining(self):
        return self._draining


@pytest.mark.parametrize("fleet", [1, 2, 3, 5, 8])
def test_affinity_picks_match_jax_for_a_seeded_key_set(fleet):
    """The same key picks the same replica in both routers, for small
    keys (affinity), large ones (balance), with dead and draining
    replicas excluded, and as the handoff target of a drain."""
    rng = random.Random(fleet)
    keys = [(rng.choice(("SUM", "MIN", "MAX", "SCAN")),
             rng.choice(("int", "float", "double", "bfloat16")),
             rng.choice((64, 1000, 1 << 16, 1 << 20,
                         rng.randrange(1, 1 << 22))))
            for _ in range(60)]
    flags = [(rng.random() > 0.2, rng.random() > 0.8) for _ in range(fleet)]
    flags[0] = (True, False)

    def picks(side):
        stubs = [_Stub(f"r{i}", *flags[i]) for i in range(fleet)]
        router = side.router.ReplicaRouter(stubs, affinity_bytes=1 << 20)
        out = []
        for m, d, n in keys:
            req = side.request.ReduceRequest(method=m, dtype=d, n=n)
            rep, policy = router._pick(req, tried=())
            target = router.affinity_target(req.method, req.dtype, n,
                                            exclude=("r0",))
            out.append((rep.replica_id, policy,
                        target.replica_id if target else None))
        return out

    got = _both(picks)
    assert {p for _, p, _ in got} <= {"affinity", "balanced"}


def _affinity_scenario(side):
    reps, exs = _replicas(side, 3)
    router = side.router.ReplicaRouter(reps).start()
    try:
        n = _affine_n(1, 3)
        pend = [router.submit(side.request.ReduceRequest(
            method="SUM", dtype="int", n=n, seed=i)) for i in range(6)]
        res = [p.result(timeout=30) for p in pend]
        return ([(r.status, r.result) for r in res],
                [len(ex.launches) > 0 for ex in exs],
                router.stats["affinity"], router.stats["balanced"],
                router.journal.placements())
    finally:
        router.stop()


def test_repeated_key_routes_to_one_replica_like_jax():
    served = _both(_affinity_scenario)
    assert served[1] == [False, True, False]


def _balance_scenario(side):
    reps, exs = _replicas(side, 2, delay_s=0.3)
    router = side.router.ReplicaRouter(reps, affinity_bytes=0).start()
    try:
        a = router.submit(side.request.ReduceRequest(method="SUM",
                                                     dtype="int", n=64))
        time.sleep(0.05)             # a is outstanding on r0
        b = router.submit(side.request.ReduceRequest(method="SUM",
                                                     dtype="int", n=64))
        return (a.result(30).status, b.result(30).status,
                [len(ex.launches) for ex in exs], router.stats["balanced"])
    finally:
        router.stop()


def test_large_requests_balance_by_outstanding_like_jax():
    assert _both(_balance_scenario) == ("ok", "ok", [1, 1], 2)


def _death_scenario(side):
    """Traffic pinned to r0, r0 killed with one batch in its executor and
    four queued: the queue sheds with engine-stopped and every shed
    request re-routes to r1 and serves."""
    reps, exs = _replicas(side, 2)
    hold = threading.Event()
    exs[0].hold = hold
    router = side.router.ReplicaRouter(reps, max_retries=2).start()
    try:
        n = _affine_n(0, 2)
        inflight = router.submit(side.request.ReduceRequest(
            method="SUM", dtype="int", n=n, seed=0))
        deadline = time.monotonic() + 30
        while not exs[0].launches:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        queued = [router.submit(side.request.ReduceRequest(
            method="SUM", dtype="int", n=n, seed=1 + i)) for i in range(4)]
        killer = threading.Thread(target=reps[0].kill)
        killer.start()
        rerouted = [p.result(timeout=30) for p in queued]
        hold.set()
        final = inflight.result(timeout=30)
        killer.join(timeout=30)
        return (final.status, [(r.status, r.result) for r in rerouted],
                router.stats["rerouted"],
                [len(ex.launches) > 0 for ex in exs],
                reps[0].alive(), reps[1].alive())
    finally:
        hold.set()
        router.stop()


def test_replica_death_reroutes_everything_like_jax():
    out = _both(_death_scenario)
    assert out[0] == "ok" and out[2] == 4
    assert [s for s, _ in out[1]] == ["ok"] * 4


def _no_replica_scenario(side):
    reps, _ = _replicas(side, 1)
    router = side.router.ReplicaRouter(reps).start()
    reps[0].kill()
    r = router.submit(side.request.ReduceRequest(
        method="SUM", dtype="int", n=64)).result(timeout=5)
    router.stop()
    return r.status, r.error, router.stats["no_replica"]


def test_no_alive_replica_resolves_like_jax():
    status, error, count = _both(_no_replica_scenario)
    assert status == "error" and "no-replica-alive" in error and count == 1


def _pair(side, hold=None, max_retries=2):
    ex_s, ex_v = FakeExecutor(), FakeExecutor(hold=hold)
    surv = side.router.LocalReplica("survivor", side.engine.ServeEngine(
        executor=ex_s, coalesce_window_s=0.0, **side.extra))
    victim = side.router.LocalReplica("victim", side.engine.ServeEngine(
        executor=ex_v, coalesce_window_s=0.0, **side.extra))
    router = side.router.ReplicaRouter([surv, victim],
                                       max_retries=max_retries).start()
    return router, victim, surv, ex_v, ex_s


def _draining_skip_scenario(side):
    router, victim, surv, ex_v, ex_s = _pair(side)
    try:
        n = _affine_n(1, 2)          # alive = [survivor, victim] -> victim
        req = side.request.ReduceRequest(method="SUM", dtype="int32", n=n)
        first = router.submit(req).result(30).status
        before = len(ex_v.launches)
        victim.drain_begin()
        second = router.submit(req).result(30).status
        return (first, second, before, len(ex_v.launches),
                len(ex_s.launches))
    finally:
        router.stop()


def test_pick_skips_a_draining_replica_like_jax():
    assert _both(_draining_skip_scenario) == ("ok", "ok", 1, 1, 1)


def _free_reroute_scenario(side, all_draining):
    router, victim, surv, ex_v, ex_s = _pair(side, max_retries=0)
    try:
        for rep in ((victim, surv) if all_draining else (victim,)):
            rep._engine.begin_drain()
            rep.draining = lambda: False     # the router cannot see it
        n = _affine_n(1, 2)
        resp = router.submit(side.request.ReduceRequest(
            method="SUM", dtype="int32", n=n)).result(30)
        return (resp.status, "no-replica-alive" in (resp.error or ""),
                router.stats["drain_rerouted"], router.stats["rerouted"],
                len(ex_s.launches))
    finally:
        router.stop()


@pytest.mark.parametrize("all_draining", [False, True],
                         ids=["one-draining", "all-draining"])
def test_draining_reroute_is_free_and_terminates_like_jax(all_draining):
    out = _both(_free_reroute_scenario, all_draining)
    if all_draining:
        assert out[:2] == ("error", True)
    else:
        assert out == ("ok", False, 1, 0, 1)


@pytest.mark.parametrize("status,error", [
    ("error", "replica-dead: r0 gone"),
    ("error", "replica-timeout: r0 silent"),
    ("error", "relay dead: probe refused"),
    ("shed", "relay-dead"),
    ("rejected", "engine-stopped"),
    ("rejected", "replica-draining: admission closed"),
    ("ok", None),
    ("error", "verification failed: ..."),
    ("rejected", "queue full (depth 64)"),
    ("expired", "deadline passed"),
    ("shed", "replica-draining"),
])
def test_failure_vocabulary_matches_jax(status, error):
    verdicts = []
    for side in SIDES.values():
        resp = side.request.ReduceResponse("r0", status, "SUM", "int32",
                                           64, error=error)
        verdicts.append((side.router.replica_failure(resp),
                         side.router.replica_draining(resp)))
    assert verdicts[0] == verdicts[1]


# ------------------------------------------------------------ journal

def _write_journal(side, path):
    j = side.journal.FleetJournal(str(path))
    j.record_replica("replica-0", state="up", port=4242, pid=777,
                     platform="cpu", relay_port=9)
    j.record_replica("replica-1", state="starting")
    j.record_replica("replica-2", state="up", port=5151, pid=999)
    j.record_replica("replica-2", state="draining")
    j.record_placement("SUM", "int32", 4096)
    j.record_placement("SUM", "int32", 4096)
    j.record_placement("MIN", "float32", 128)
    j.record_autoscaler({"last_action_wall": 123.0, "calm": 2,
                         "next_idx": 3, "last_action": "up",
                         "cooldown_s": 5.0})
    return j


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_journal_replays_in_the_other_package(tmp_path, writer, reader):
    path = tmp_path / "fleet_journal.json"
    w = _write_journal(SIDES[writer], path)
    r = SIDES[reader].journal.FleetJournal(str(path))
    assert r.replicas() == w.replicas()
    assert r.replicas()["replica-2"] == {"state": "draining", "port": 5151,
                                         "pid": 999}
    assert r.placements() == w.placements() == [("SUM", "int32", 4096),
                                                ("MIN", "float32", 128)]
    assert r.autoscaler_state() == w.autoscaler_state()
    data = json.loads(path.read_text())
    assert set(data) == {"instrument", "version", "wall", "replicas",
                         "placements", "autoscaler"}


def test_journal_files_of_both_packages_have_the_same_keys(tmp_path):
    docs = {}
    for name, side in SIDES.items():
        _write_journal(side, tmp_path / f"{name}.json")
        d = json.loads((tmp_path / f"{name}.json").read_text())
        d.pop("wall")
        docs[name] = d
    assert docs["port"] == docs["jax"]
    assert port_journal.JOURNAL_META == jax_journal.JOURNAL_META
    assert port_journal.REPLICA_STATES == jax_journal.REPLICA_STATES


def test_journal_meta_contract_and_refusals(tmp_path):
    path = tmp_path / "j.json"
    _write_journal(SIDES["port"], path)
    data = json.loads(path.read_text())
    data["version"] += 1
    path.write_text(json.dumps(data))
    for side in SIDES.values():
        j = side.journal.FleetJournal(str(path))
        assert j.replicas() == {} and j.placements() == []
        assert j.autoscaler_state() is None
    msgs = []
    for side in SIDES.values():
        with pytest.raises(ValueError) as e:
            side.journal.FleetJournal(None).record_replica("x",
                                                          state="exploded")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    mem = port_journal.FleetJournal(None)
    mem.record_replica("replica-0", state="up", port=1, pid=2)
    mem.forget_replica("replica-0")
    assert mem.replicas() == {}


def _dead_pid_and_port():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=30)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return proc.pid, port


def test_adopt_fleet_stale_and_dead_verdicts_like_jax(tmp_path):
    pid, port = _dead_pid_and_port()
    out = {}
    for name, side in SIDES.items():
        path = str(tmp_path / f"{name}.json")
        j = side.journal.FleetJournal(path)
        j.record_replica("replica-0", state="starting")
        j.record_replica("replica-1", state="up", port=port, pid=pid)
        j.record_replica("replica-2", state="down", port=port, pid=pid)
        adopted, reaped = side.router.adopt_fleet(j, reap_grace_s=0.2)
        out[name] = (adopted, reaped, j.replicas(),
                     side.journal.FleetJournal(path).replicas())
    assert out["port"] == out["jax"] == ([], ["replica-1"], {}, {})


# ------------------------------------------------------- relay and gate

def _until_refused(port, limit_s=5.0):
    """Wait until a connect to `port` is refused: a relay whose schedule
    starts with `refuse` listens from `start()` (to learn its port) until
    its behaviour thread's first tick closes the listener, a window that
    a loaded host can stretch past the scenario's first probe."""
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
        except ConnectionRefusedError:
            return
        except OSError:
            pass
        time.sleep(0.02)
    raise AssertionError(f"the relay on {port} still accepts after "
                         f"{limit_s} s")


def _gate_scenario(side, schedule, delay):
    with side.relay.FakeRelay([side.Phase(**p) for p in schedule]) as relay:
        if schedule[0]["behavior"] == "refuse":
            _until_refused(relay.port)
        gate = side.transport.RelayTransport(
            ports=(relay.port,), assume_tunneled=True, drain=True,
            connect_timeout_s=0.5, read_cap_s=1.0)
        out = []
        for _ in range(3):
            try:
                dt = gate.gate()
                out.append(("ok", dt >= delay * 0.9))
            except side.request.TransportDead as e:
                out.append(("dead", "refuses on every probe port"
                            in str(e)))
            time.sleep(0.15)
        return out, relay.behavior


@pytest.mark.parametrize("schedule,delay", [
    ([{"behavior": "slow", "delay_s": 0.2}], 0.2),
    ([{"behavior": "accept"}], 0.0),
    ([{"behavior": "refuse"}], 0.0),
    ([{"behavior": "accept", "connections": 1}, {"behavior": "refuse"}],
     0.0),
], ids=["slow", "accept", "refuse", "accept-then-refuse"])
def test_relay_and_gate_delay_and_drop_like_jax(schedule, delay):
    out, behavior = _both(_gate_scenario, schedule, delay)
    assert behavior == schedule[-1]["behavior"]
    if behavior == "refuse" and len(schedule) == 1:
        assert out == [("dead", True)] * 3
    elif behavior == "refuse":
        assert out[0] == ("ok", True) and out[-1] == ("dead", True)
    else:
        assert out == [("ok", True)] * 3


def test_the_gate_is_free_off_the_relay_and_null_never_gates(monkeypatch):
    monkeypatch.delenv("TPU_REDUCTIONS_RELAY_MARKER", raising=False)
    assert port_transport.RelayTransport().gate() == 0.0
    assert port_transport.NullTransport().gate() == 0.0


def test_a_stalled_relay_is_bounded_by_the_read_cap():
    with port_relay.FakeRelay([Phase("stall")]) as relay:
        gate = port_transport.RelayTransport(
            ports=(relay.port,), assume_tunneled=True, drain=True,
            read_cap_s=0.3)
        t0 = time.monotonic()
        assert 0.25 <= gate.gate() < 5.0
        assert time.monotonic() - t0 < 5.0
        assert relay.connections == 1


def test_force_overrides_the_schedule_and_refuses_unknown():
    with port_relay.FakeRelay() as relay:
        assert relay.behavior == "accept"
        relay.force("slow", delay_s=0.1)
        time.sleep(0.1)    # the behaviour thread's accept tick ends
        gate = port_transport.RelayTransport(ports=(relay.port,),
                                             assume_tunneled=True)
        assert gate.gate() >= 0.09
        with pytest.raises(ValueError, match="unknown behavior"):
            relay.force("melt")


def _relay_engine_scenario(side):
    """The relay's slow mode through an engine: the quota verdicts are
    scripted by the gate's delay, not raced."""
    with side.relay.FakeRelay([side.Phase("slow", delay_s=0.3)]) as relay:
        eng = side.engine.ServeEngine(
            executor=FakeExecutor(), coalesce_window_s=0.0, tenant_quota=2,
            max_queue=16, transport=side.transport.RelayTransport(
                ports=(relay.port,), assume_tunneled=True, drain=True,
                connect_timeout_s=0.5), **side.extra).start()
        try:
            req = side.request.ReduceRequest
            flight = eng.submit(req(method="SUM", dtype="int", n=64,
                                    tenant="a"))
            time.sleep(0.1)
            qa = [eng.submit(req(method="SUM", dtype="int", n=64, seed=i,
                                 tenant="a")) for i in range(2)]
            over = eng.submit(req(method="SUM", dtype="int", n=64, seed=9,
                                  tenant="a"))
            other = eng.submit(req(method="SUM", dtype="int", n=64,
                                   tenant="b"))
            r = over.result(timeout=5)
            rest = [p.result(timeout=30).status
                    for p in (flight, *qa, other)]
            return r.status, "tenant quota" in (r.error or ""), rest
        finally:
            eng.stop()


def test_slow_relay_scripts_the_tenant_quota_like_jax():
    assert _both(_relay_engine_scenario) == ("rejected", True, ["ok"] * 4)


def test_local_router_wires_a_transport_per_replica():
    with port_relay.FakeRelay() as relay:
        transports = [port_transport.RelayTransport(
            ports=(relay.port,), assume_tunneled=True, drain=True,
            connect_timeout_s=0.5) for _ in range(2)]
        router = port_router.local_router(2, engine_kwargs={
            "transports": transports, "executor": FakeExecutor(),
            "coalesce_window_s": 0.0, "platform": "cpu"}).start()
        try:
            r = router.submit(port_request.ReduceRequest(
                method="SUM", dtype="int", n=64)).result(timeout=30)
            assert r.status == "ok"
            assert relay.connections >= 1
            assert [rep._engine._transport for rep in router.replicas] \
                == transports
        finally:
            router.stop()


def test_relay_cli_runs_and_writes_its_port(tmp_path):
    port_file = tmp_path / "port"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.faults.relay",
         "--schedule", '[{"behavior": "accept"}]', "--platform=cpu",
         f"--port-file={port_file}", "--max-seconds=0.3"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "fake relay: listening on 127.0.0.1:" in proc.stdout
    assert int(port_file.read_text()) > 0


# --------------------------------------------------- process replicas

def _pid_dead(pid):
    try:
        os.kill(pid, 0)
        return False
    except OSError:
        return True


def test_process_replica_tier_survives_a_kill():
    """Two real `python -m tpu_reductions_torch.serve --platform cpu`
    children serve routed traffic; after one is killed, a submit to the
    corpse resolves replica-dead and the router serves through the
    survivor; stop leaves no child alive."""
    reps = [port_router.ProcessReplica(f"p{i}", platform="cpu")
            for i in range(2)]
    router = port_router.ReplicaRouter(reps, max_retries=2)
    try:
        router.start()
        assert all(r.spawn_s is not None and r.spawn_s > 0 for r in reps)
        assert reps[0].ping()
        first = [router.submit(port_request.ReduceRequest(
            method="SUM", dtype="int", n=256, seed=i)) for i in range(4)]
        assert all(p.result(timeout=120).status == "ok" for p in first)
        reps[0].kill()
        reps[0]._proc.wait(timeout=30)
        assert not reps[0].alive()
        r = reps[0].submit(port_request.ReduceRequest(
            method="SUM", dtype="int", n=256)).result(timeout=30)
        assert r.status == "error" and "replica-dead" in r.error
        after = [router.submit(port_request.ReduceRequest(
            method="MIN", dtype="int", n=256, seed=i)) for i in range(4)]
        res = [p.result(timeout=120) for p in after]
        assert all(x.status == "ok" for x in res), \
            [(x.status, x.error) for x in res]
        assert reps[1].stats()["ok"] >= 4
    finally:
        router.stop()
    pids = [r.pid for r in reps]
    assert all(_pid_dead(p) for p in pids)


def test_a_process_replica_shards_over_its_devices(monkeypatch):
    """`devices` reaches the child's executor: a request over the (here
    lowered) shard threshold takes the shard route over 8 ranks."""
    monkeypatch.setenv("TPU_REDUCTIONS_SHARD_THRESHOLD_BYTES", "1048576")
    rep = port_router.ProcessReplica("p", platform="cpu", devices=8)
    try:
        rep.start()
        r = rep.submit(port_request.ReduceRequest(
            method="MAX", dtype="int", n=1 << 19, seed=4)).result(120)
        assert r.status == "ok", r.error
        assert rep.stats()["sharded"] == 1
    finally:
        rep.stop()
    assert not rep.alive()


def test_a_child_that_cannot_start_fails_its_spawn():
    """A child that exits at once (here: an unknown flag) fails the
    spawn with its exit code and the tail of its standard error."""
    rep = port_router.ProcessReplica("bad", platform="cpu",
                                     extra_args=["--no-such-flag"])
    with pytest.raises(RuntimeError, match="died during spawn.*no-such"):
        rep.start()
    assert not rep.alive()


# ------------------------------------------------- router-crash e2e

def _spawn_router(jpath, port_file, env, log):
    if os.path.exists(port_file):
        os.unlink(port_file)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_reductions_torch.serve.router",
         "--replicas", "2", "--platform", "cpu", "--journal", jpath,
         "--port-file", port_file, "--max-seconds", "300"],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"router died during spawn "
                               f"(exit {proc.returncode})")
        if os.path.exists(port_file):
            return proc
        time.sleep(0.05)
    proc.kill()
    raise TimeoutError("router never published its port")


def test_router_crash_recovery_e2e(tmp_path):
    """A journaled port router over two process replicas dies by the
    scripted `router.crash` exit mid-burst; clients retry with their
    idempotency keys; a restart on the same journal re-adopts both
    children (same pids); every request settles ok once, the ledger
    shows no duplicate device execution, and teardown leaves no child."""
    jpath = str(tmp_path / "fleet_journal.json")
    port_file = str(tmp_path / "router.port")
    ledger_path = str(tmp_path / "ledger.jsonl")
    plan = port_loadgen._stamp_idem(port_loadgen.plan_workload(
        7, count=12, methods=["SUM", "MIN"], dtype="int",
        n_choices=[4096], rate_rps=200.0), "e2e-")
    base_env = {k: v for k, v in os.environ.items()
                if not k.startswith("TPU_REDUCTIONS_")}
    base_env["TPU_REDUCTIONS_LEDGER"] = ledger_path
    crash_env = dict(base_env)
    crash_env["TPU_REDUCTIONS_FAULTS"] = json.dumps(
        {"router.crash": {"after": 4, "action": "exit", "code": 86}})
    log = open(tmp_path / "router.log", "wb")
    procs = []
    pids = []
    try:
        procs.append(_spawn_router(jpath, port_file, crash_env, log))
        rows = []
        client = threading.Thread(target=lambda: rows.extend(
            port_loadgen._recovery_client(port_file, plan, clients=3,
                                          retry_window_s=180.0)),
            daemon=True)
        client.start()
        assert procs[0].wait(timeout=120) == 86
        pids = [int(e["pid"]) for e in json.loads(
            open(jpath).read())["replicas"].values()
            if e.get("state") == "up"]
        assert len(pids) == 2 and not any(_pid_dead(p) for p in pids)
        procs.append(_spawn_router(jpath, port_file, base_env, log))
        client.join(timeout=180)
        assert not client.is_alive()
        assert len(rows) == len(plan)
        assert all(r["status"] == "ok" for r in rows), rows
        assert any(r["attempts"] > 1 for r in rows)
        after = [int(e["pid"]) for e in json.loads(
            open(jpath).read())["replicas"].values()
            if e.get("state") == "up"]
        assert sorted(after) == sorted(pids)
        ev = port_loadgen._recovery_evidence(ledger_path, "e2e-")
        assert ev["executed_keys"] == len(plan)
        assert ev["duplicates"] == 0
        assert ev["adopted"] == 2 and ev["reaped"] == 0
        procs[1].send_signal(signal.SIGINT)
        assert procs[1].wait(timeout=60) == 0
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and not all(_pid_dead(p) for p in pids):
            time.sleep(0.1)
        assert all(_pid_dead(p) for p in pids)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(signal.SIGINT)
        for pr in procs:
            try:
                pr.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait(timeout=30)
        port_loadgen._sweep_journal(jpath, grace_s=5.0)
        log.close()
