"""The port's flight recorder against the JAX package's: the ledger and
its trace context (obs/), the heartbeat, the fault plan and the retry
classification. The same calls on both sides must give ledger lines with
the same events, keys, key order and parent links (`t`, `pid` and the
minted ids differ by nature), the same rotation, the same firings and the
same retry verdicts."""

import itertools
import json

import pytest

from tpu_reductions.faults import inject as jax_inject
from tpu_reductions.faults import schedule as jax_schedule
from tpu_reductions.obs import ledger as jax_ledger
from tpu_reductions.obs import trace as jax_trace
from tpu_reductions.utils import heartbeat as jax_heartbeat
from tpu_reductions.utils import retry as jax_retry
from tpu_reductions_torch.faults import inject as port_inject
from tpu_reductions_torch.faults import schedule as port_schedule
from tpu_reductions_torch.obs import ledger as port_ledger
from tpu_reductions_torch.obs import trace as port_trace
from tpu_reductions_torch.utils import heartbeat as port_heartbeat
from tpu_reductions_torch.utils import retry as port_retry

SIDES = {"jax": (jax_ledger, jax_trace, jax_heartbeat, jax_inject),
         "port": (port_ledger, port_trace, port_heartbeat, port_inject)}
ENV = ("TPU_REDUCTIONS_LEDGER", "TPU_REDUCTIONS_OBS_DISABLE",
       "TPU_REDUCTIONS_LEDGER_MAX_BYTES", "TPU_REDUCTIONS_TRACE_CTX",
       "TPU_REDUCTIONS_FAULTS", "TPU_REDUCTIONS_DEVICE_RETRIES")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for ledger, trace, heartbeat, inject in SIDES.values():
        ledger.disarm()
        heartbeat.reset()
        inject.reset()
    yield
    for ledger, trace, heartbeat, inject in SIDES.values():
        ledger.disarm()
        heartbeat.reset()
        inject.reset()


def _lines(path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _shape(lines: list) -> list:
    """Each line as (its keys in order, its fields with the ids renamed
    by first appearance and `t`/`pid` dropped): equal shapes mean equal
    events, keys, key order and parent links."""
    names = {}

    def name(v):
        return names.setdefault(v, f"id{len(names)}")

    out = []
    for rec in lines:
        fields = {k: (name(v) if k in ("trace", "span", "parent") else v)
                  for k, v in rec.items() if k not in ("t", "pid")}
        out.append((list(rec), fields))
    return out


def _script(side: str):
    """One sequence of emits, spans, request contexts and guards."""
    ledger, trace, heartbeat, _ = SIDES[side]
    ledger.emit("session.start", prog="t", argv=["a", 1])
    ledger.emit("plain.event", x=1, f=float("nan"), t2=(1, 2),
                nested={"a": [1, 2.5]})
    with trace.child():
        ledger.emit("exec.plan", surface="s", kind="bench")
        with trace.child():
            ledger.emit("inner.one", v=None)
        with heartbeat.guard("serve"):
            ledger.emit("inside.guard")
            heartbeat.tick("steady")
            ledger.emit("after.relabel")
    rid = "r000007"
    with trace.activate(trace.request_context(rid)):
        ledger.emit("serve.enqueue", req=rid, **trace.request_fields(rid))
        ledger.emit("ambient.request")
    ledger.emit("serve.respond", req=rid, phase=None,
                **trace.request_fields(rid))
    assert ledger.emit("Bad-Name") is False
    trace.cut("watchdog", exit=3)


def test_ledger_lines_match_jax(tmp_path):
    shapes = {}
    for side in SIDES:
        ledger, trace, _, _ = SIDES[side]
        path = tmp_path / f"{side}.jsonl"
        assert ledger.arm(path) == str(path)
        assert ledger.armed()
        trace.ensure_root()
        _script(side)
        ledger.disarm()
        shapes[side] = _shape(_lines(path))
    assert shapes["port"] == shapes["jax"]
    assert [f["ev"] for _, f in shapes["port"]][:3] == [
        "session.start", "plain.event", "exec.plan"]
    # the hb.phase transitions are recorded on both sides
    assert sum(f["ev"] == "hb.phase" for _, f in shapes["port"]) == 3


def test_child_without_a_ledger_mints_nothing(tmp_path):
    for side in SIDES:
        ledger, trace, _, _ = SIDES[side]
        with trace.child() as ctx:
            assert ctx is None
        assert trace.active() is None
        assert ledger.emit("x.y") is False


def test_trace_wire_form_matches_jax(monkeypatch):
    for value in ("abc:def", "abc", ":x", "a b:c", "t-1.2_x:s9", "", None):
        want = jax_trace.decode(value)
        got = port_trace.decode(value)
        assert (got is None) == (want is None), value
        if got is not None:
            assert got.encode() == want.encode() == value
    monkeypatch.setenv("TPU_REDUCTIONS_TRACE_CTX", "tr1:sp1")
    for trace in (jax_trace, port_trace):
        trace.reset()
        root = trace.ensure_root()
        assert (root.trace_id, root.parent_id) == ("tr1", "sp1")
        assert trace.adopted()
        env = trace.propagation_env()
        assert list(env) == ["TPU_REDUCTIONS_TRACE_CTX"]
        assert env["TPU_REDUCTIONS_TRACE_CTX"].startswith("tr1:")
        trace.reset()
    assert port_trace.request_fields("r1") == jax_trace.request_fields("r1")


def test_rotation_and_disable_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_REDUCTIONS_LEDGER_MAX_BYTES", "300")
    counts = {}
    for side in SIDES:
        ledger = SIDES[side][0]
        path = tmp_path / f"{side}.jsonl"
        ledger.arm(path)
        landed = [ledger.emit("rot.line", i=i, pad="x" * 40)
                  for i in range(12)]
        ledger.disarm()
        rolled = tmp_path / f"{side}.jsonl.1"
        counts[side] = (landed, len(_lines(path)), len(_lines(rolled)))
        assert all(landed) and rolled.exists()
    assert counts["port"] == counts["jax"]
    monkeypatch.setenv("TPU_REDUCTIONS_OBS_DISABLE", "1")
    for side in SIDES:
        ledger = SIDES[side][0]
        assert ledger.arm(tmp_path / f"off-{side}.jsonl") is None
        assert ledger.emit("x.y") is False
        assert not ledger.armed()
    monkeypatch.delenv("TPU_REDUCTIONS_OBS_DISABLE")
    monkeypatch.setenv("TPU_REDUCTIONS_LEDGER", str(tmp_path / "env.jsonl"))
    for side in SIDES:
        ledger = SIDES[side][0]
        assert ledger.arm_session("p", argv=["x"]) == str(
            tmp_path / "env.jsonl")
        ledger.disarm()
    evs = [r["ev"] for r in _lines(tmp_path / "env.jsonl")]
    assert evs == ["session.start", "session.start"]


@pytest.mark.parametrize("spec", [
    {"after": 2, "times": 2, "action": "suppress"},
    {"action": "dead"},
    {"after": 1, "times": 1, "action": "raise", "message": "flap"},
    {"after": 3},
], ids=["window", "forever", "raise-once", "raise-after"])
def test_fault_point_fires_on_the_jax_schedule(spec, monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_REDUCTIONS_FAULTS",
                       json.dumps({"serve.batch": spec}))
    seen = {}
    for side in SIDES:
        ledger, _, _, inject = SIDES[side]
        ledger.arm(tmp_path / f"{side}.jsonl")
        out = []
        for _ in range(6):
            try:
                r = inject.fault_point("serve.batch")
                out.append(None if r is None else r.get("action"))
            except Exception as e:
                out.append(f"{type(e).__name__}: {e}")
            assert inject.fault_point("other.point") is None
        ledger.disarm()
        fires = [r for r in _lines(tmp_path / f"{side}.jsonl")
                 if r["ev"] == "fault.fire"]
        seen[side] = (out, [(r["point"], r["action"], r["hit"])
                            for r in fires])
    assert seen["port"] == seen["jax"]


def test_malformed_fault_plan_is_loud(monkeypatch):
    monkeypatch.setenv("TPU_REDUCTIONS_FAULTS", "{not json")
    for inject in (jax_inject, port_inject):
        inject.reset()
        with pytest.raises(ValueError, match="malformed fault plan"):
            inject.fault_point("x")
    monkeypatch.setenv("TPU_REDUCTIONS_FAULTS", "[1]")
    for inject in (jax_inject, port_inject):
        inject.reset()
        with pytest.raises(ValueError, match="must be a JSON object"):
            inject.fault_point("x")


def test_heartbeat_suppress_freezes_the_mark(monkeypatch):
    monkeypatch.setenv("TPU_REDUCTIONS_FAULTS",
                       json.dumps({"heartbeat.tick": {"action":
                                                      "suppress"}}))
    snaps = {}
    for side in SIDES:
        heartbeat = SIDES[side][2]
        with heartbeat.guard("compile"):
            heartbeat.tick("steady")
            s = heartbeat.snapshot()
        snaps[side] = (s["in_flight"], s["phase"], s["beats"],
                       heartbeat.snapshot()["in_flight"])
    assert snaps["port"] == snaps["jax"]


def test_heartbeat_phases_and_deadlines_match_jax(monkeypatch):
    snaps = {}
    for side in SIDES:
        heartbeat = SIDES[side][2]
        trail = [heartbeat.snapshot()["phase"]]
        heartbeat.tick("ignored")           # outside a guard: nothing
        with heartbeat.guard("compile"):
            trail.append(heartbeat.snapshot()["phase"])
            heartbeat.tick("steady")
            with heartbeat.guard("serve"):
                trail.append(heartbeat.snapshot()["phase"])
            trail.append(heartbeat.snapshot()["phase"])
        s = heartbeat.snapshot()
        snaps[side] = (trail, s["in_flight"], s["phase"], s["beats"])
    assert snaps["port"] == snaps["jax"]
    monkeypatch.setenv("TPU_REDUCTIONS_HEARTBEAT_DEADLINE_S", "7")
    for phase in ("compile", "serve", None):
        assert port_heartbeat.deadline_for(phase) == \
            jax_heartbeat.deadline_for(phase)


@pytest.mark.parametrize("sched", [
    '[{"behavior": "accept", "duration_s": 2}, {"behavior": "refuse", '
    '"duration_s": 1}, {"behavior": "slow", "delay_s": 0.5}]',
    '[{"behavior": "refuse", "connections": 3}]',
    '[{"behavior": "bogus"}]',
    '[{"behavior": "accept", "delay_s": 1}]',
    '[{"behavior": "accept", "extra": 1}]',
    '[]',
], ids=["flap", "refuse-connections", "bogus", "delay-off-slow",
        "unknown-key", "empty"])
def test_schedule_parse_matches_jax(sched):
    def parse(mod):
        try:
            return [(p.behavior, p.duration_s, p.connections, p.hold_s)
                    for p in mod.load_schedule(sched)]
        except ValueError as e:
            return f"ValueError: {e}"
    assert parse(port_schedule) == parse(jax_schedule)


class _Flaky:
    def __init__(self, fails: int):
        self.fails, self.calls = fails, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise RuntimeError(f"flap {self.calls}")
        return "done"


@pytest.mark.parametrize("tunneled,alive,fails,budget",
                         list(itertools.product((True, False), (True, False),
                                                (0, 1, 3), (None, 0, 2))))
def test_retry_classification_matches_jax(tunneled, alive, fails, budget):
    got = {}
    for name, mod in (("jax", jax_retry), ("port", port_retry)):
        fn, sleeps, logs = _Flaky(fails), [], []
        try:
            out = mod.retry_device_call(
                fn, retries=budget, _sleep=sleeps.append, log=logs.append,
                _tunneled=lambda: tunneled, _alive=lambda: alive,
                phase="serve")
        except RuntimeError as e:
            out = f"raised {e}"
        got[name] = (out, fn.calls, sleeps, logs)
    assert got["port"] == got["jax"]


def test_retry_budget_env_matches_jax(monkeypatch):
    for value in ("5", "0", "x"):
        monkeypatch.setenv("TPU_REDUCTIONS_DEVICE_RETRIES", value)
        assert port_retry.retry_budget() == jax_retry.retry_budget()
    assert port_retry.retry_budget(3) == 3


def test_a_local_card_is_untunneled(monkeypatch, tmp_path):
    """No relay marker: a CUDA error re-raises at once, with no retry."""
    from tpu_reductions_torch.utils import watchdog
    monkeypatch.delenv("TPU_REDUCTIONS_RELAY_MARKER", raising=False)
    assert watchdog.tunneled_environment() is False
    marker = tmp_path / "relay"
    marker.write_text("")
    monkeypatch.setenv("TPU_REDUCTIONS_RELAY_MARKER", str(marker))
    assert watchdog.tunneled_environment() is True
    monkeypatch.delenv("TPU_REDUCTIONS_RELAY_MARKER")
    fn = _Flaky(1)
    with pytest.raises(RuntimeError, match="flap 1"):
        port_retry.retry_device_call(fn, _sleep=lambda s: None)
    assert fn.calls == 1


def test_relay_probe_reads_ports(monkeypatch):
    import socket

    from tpu_reductions_torch.utils import watchdog
    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        assert watchdog.relay_alive((port,)) is True
        monkeypatch.setenv("TPU_REDUCTIONS_RELAY_PORTS", str(port))
        assert watchdog.relay_alive() is True
    assert watchdog.relay_alive((port,), timeout_s=0.5) is False


def test_ledger_cli_appends_one_event(tmp_path):
    path = tmp_path / "l.jsonl"
    assert port_ledger.main(["cli.note", "a=1", "b=2.5", "c=x",
                             f"--ledger={path}", "--platform=cpu"]) == 0
    rec = _lines(path)[0]
    assert (rec["ev"], rec["a"], rec["b"], rec["c"]) == ("cli.note", 1,
                                                          2.5, "x")
    port_ledger.disarm()
    assert port_ledger.main(["cli.note", "--platform=cpu"]) == 1
