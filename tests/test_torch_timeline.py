"""The flight recorder's analysis in both packages: the same ledger, read
by the JAX package's obs/{timeline,trace_export,critical_path} and by the
port's, must give the same timeline summary, Chrome trace, critical path
and span medians (as JSON, floats to 1e-9), and the same report text.

The ledgers: fixtures shaped as the JAX tests' (tests/test_obs.py,
tests/test_trace.py: attribution, stall and retry carving, torn lines,
sessions per pid, span pairing, orphans closed at trace.cut, point
durations, request spans, flows across processes) plus one with every
summary's events; and ledgers written by `--platform=cpu` runs of the
port: the main CLI, spot, the stream interrupted at `stream.chunk` and
resumed, the serving engine, and the scheduler. Every event name a port
run wrote must be a registered JAX event name."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_reductions.lint.grammar import REGISTERED_EVENTS
from tpu_reductions.obs import critical_path as jax_cp
from tpu_reductions.obs import timeline as jax_tl
from tpu_reductions.obs import trace_export as jax_te
from tpu_reductions_torch.obs import critical_path as port_cp
from tpu_reductions_torch.obs import ledger as port_ledger
from tpu_reductions_torch.obs import timeline as port_tl
from tpu_reductions_torch.obs import trace_export as port_te

REPO = Path(__file__).resolve().parents[1]
ENV = ("TPU_REDUCTIONS_LEDGER", "TPU_REDUCTIONS_FAULTS",
       "TPU_REDUCTIONS_TRACE_CTX", "TPU_REDUCTIONS_OBS_DISABLE")


def _ev(t, ev, pid=1, **fields):
    return {"t": t, "ev": ev, "pid": pid, **fields}


def _session(pid, t0, prog, trace_id, span_id, parent=None):
    e = _ev(t0, "session.start", pid=pid, prog=prog, trace=trace_id,
            span=span_id)
    if parent:
        e["parent"] = parent
    return e


FIXTURES = {
    # the attribution math: phases, a retry carved from host time
    "attribution": [
        _ev(100.0, "session.start", prog="tpu_reductions"),
        _ev(101.0, "hb.phase", phase="compile", prev=None),
        _ev(104.0, "hb.phase", phase="staging", prev="compile"),
        _ev(105.0, "hb.phase", phase="periter", prev="staging"),
        _ev(109.0, "hb.phase", phase=None, prev="periter"),
        _ev(109.5, "retry.attempt", attempt=1, budget=3, backoff_s=0.25),
        _ev(110.0, "artifact.persist", path="a.json", rows=1,
            complete=False),
        _ev(110.2, "resume.reuse", key="k", path="a.json"),
        _ev(111.0, "session.end", code=0)],
    # an exit-4 stall carved out of its guard's bucket
    "stall": [
        _ev(0.0, "session.start", prog="bench.spot"),
        _ev(1.0, "hb.phase", phase="chained", prev=None),
        _ev(200.0, "watchdog.exit", code=4, age_s=150.0, phase="chained",
            deadline_s=120.0, relay="alive", beats=3)],
    # two pids, one cut (no terminal event), a torn line added on disk
    "sessions": [
        _ev(0.0, "session.start", pid=7, prog="a"),
        _ev(0.5, "session.start", pid=8, prog="b"),
        _ev(1.0, "hb.phase", pid=7, phase="compile", prev=None),
        _ev(2.0, "hb.phase", pid=8, phase="periter", prev=None),
        _ev(3.0, "session.end", pid=7, code=0),
        _ev(3.5, "session.start", pid=7, prog="c"),
        _ev(4.0, "fault.fire", pid=7, point="bench.run", action="exit",
            hit=1)],
    # span pairing by id and by name, legacy pairs, point durations,
    # an orphan closed at trace.cut, another at its pid's last event
    "spans": [
        _session(1, 0.0, "sched", "T", "s0"),
        _ev(0.1, "compile.start", trace="T", span="c1", parent="s0",
            surface="k6"),
        _ev(0.2, "staging.start", trace="T", span="g1", parent="c1"),
        _ev(0.6, "staging.end", trace="T", span="g1", parent="c1"),
        _ev(0.9, "compile.end", trace="T", span="c1", parent="s0",
            surface="k6", dur_s=0.8, verdict="cold"),
        _ev(1.0, "collective.launch", algorithm="ring_rs_ag"),
        _ev(1.5, "collective.done", algorithm="ring_rs_ag", wall_s=0.5),
        _ev(1.6, "chain.trip", trace="T", span="s0", k=17, trip=3,
            dur_s=0.05, phase="chained"),
        _ev(1.7, "exec.done", surface="k6", ok=True, exec_s=0.02),
        _ev(2.0, "stream.start", trace="T", span="o1", parent="s0"),
        _ev(2.5, "trace.cut", trace="T", reason="window-death-resume"),
        _ev(2.6, "serve.start", pid=2),
        _ev(3.0, "hb.phase", pid=2, phase="serve", prev=None)],
    # requests: enqueue -> respond with the queue split, a shed, an orphan
    "requests": [
        _ev(0.0, "session.start", prog="serve"),
        _ev(0.1, "serve.enqueue", req="r1", method="SUM", n=64,
            trace="r1", span="r1"),
        _ev(0.2, "serve.enqueue", req="r2", method="MIN", n=64,
            trace="r2", span="r2"),
        _ev(0.3, "serve.launch", batch_size=2, surface="serve-bucket/sum",
            exec_s=0.05),
        _ev(0.4, "serve.respond", req="r1", status="ok", batch_size=2,
            queue_s=0.15, latency_s=0.3, trace="r1", span="r1"),
        _ev(0.5, "serve.respond", req="r2", status="ok", batch_size=2,
            queue_s=0.2, latency_s=0.3, trace="r2", span="r2"),
        _ev(0.6, "serve.enqueue", req="r3", method="SUM", n=64),
        _ev(0.7, "serve.shed", req="r3", reason="queue-full",
            queue_depth=9),
        _ev(0.8, "serve.respond", req="r9", status="error"),
        _ev(0.9, "route.done", req="r1", replica="replica-0",
            status="ok", latency_s=0.3),
        _ev(1.0, "route.reroute", req="r2", replica="replica-1",
            reason="down"),
        _ev(1.1, "replica.down", replica="replica-1", reason="exit"),
        _ev(1.2, "session.end", code=0)],
    # flows: a child process parented under the executor's span
    "flows": [
        _session(10, 0.0, "sched", "T1", "a0"),
        _ev(0.1, "sched.plan", pid=10, trace="T1", span="a0",
            tasks=["x", "y"], est_s=[1.0, 2.0], remaining_s=360.0),
        _ev(0.2, "sched.pick", pid=10, trace="T1", span="a0", task="x",
            est_s=1.0, value=2.0, fits=True),
        _session(11, 0.3, "bench.spot", "T1", "b0", parent="a0"),
        _ev(0.4, "compile.start", pid=11, trace="T1", span="b1",
            parent="b0", surface="k7"),
        _ev(0.9, "compile.end", pid=11, trace="T1", span="b1", parent="b0",
            surface="k7", dur_s=0.5, verdict="warm"),
        _ev(1.0, "session.end", pid=11, trace="T1", span="b0", code=0),
        _ev(1.1, "sched.done", pid=10, trace="T1", span="a0", task="x",
            rc=0, actual_s=0.9, planned_s=1.0, status="done"),
        _ev(1.2, "sched.skip", pid=10, trace="T1", span="a0", task="y",
            reason="chip-only"),
        _ev(1.3, "sched.replan", pid=10, trace="T1", span="a0", tasks=[],
            est_s=[], remaining_s=358.7),
        _ev(1.4, "session.end", pid=10, trace="T1", span="a0", code=0)],
    # every other summary's events
    "summaries": [
        _ev(0.0, "session.start", prog="everything"),
        _ev(0.1, "stream.start", method="SUM", n=1024, num_chunks=4,
            start_chunk=0, sync_every=2),
        _ev(0.2, "stream.chunk", chunk=0, chunks_done=1, total=4,
            stage_s=0.01, fold_s=0.02),
        _ev(0.3, "stream.sync", chunks_done=2, total=4, elapsed_s=0.2),
        _ev(0.4, "stream.end", chunks=4, resumed_from=1, wall_s=0.3,
            gbps=1.5, chunks_per_s=10.0),
        _ev(0.5, "stream.serial", wall_s=0.6, chunks=4, gbps=0.7),
        _ev(0.6, "stream.overlap", stream_wall_s=0.3, serial_wall_s=0.6,
            efficiency=2.0),
        _ev(0.7, "collective.select", algorithm="q8_ring_rs_ag",
            method="SUM", dtype="float32", ranks=8, wire_factor=0.25,
            quantized=True, bits=8),
        _ev(0.8, "collective.launch", algorithm="q8_ring_rs_ag",
            method="SUM", dtype="float32", ranks=8, n=4096),
        _ev(0.9, "collective.done", algorithm="q8_ring_rs_ag",
            method="SUM", dtype="float32", ranks=8, wall_s=0.1, rows=1),
        _ev(1.0, "reshard.plan", src="S0", dst="R", program=["all_gather"],
            wire_bytes=1024, mem_factor=1.5, ranks=4),
        _ev(1.1, "reshard.step", primitive="all_gather",
            algorithm="ring", wall_s=0.05, mem_factor=1.25, ranks=4),
        _ev(1.2, "reshard.done", src="S0", dst="R", steps=1, wall_s=0.05,
            measured_mem_factor=1.25),
        _ev(1.3, "autoscale.tick", replicas=2, load=3.5, queued=4),
        _ev(1.4, "autoscale.up", replica="replica-2", replicas=3,
            prewarmed=2),
        _ev(1.5, "autoscale.down", replica="replica-2", replicas=2),
        _ev(1.6, "drain.reshard", replica="replica-2", program="p",
            ok=True, measured_mem_factor=1.1),
        _ev(1.7, "drain.done", replica="replica-2", waited_s=0.2, keys=3,
            shed=0, expired=0, reshard_ok=True),
        _ev(1.8, "adopt.begin", replicas=2),
        _ev(1.9, "adopt.replica", replica="replica-0", verdict="adopted"),
        _ev(2.0, "adopt.replica", replica="replica-1", verdict="reaped"),
        _ev(2.1, "adopt.done", adopted=1, reaped=1),
        _ev(2.2, "journal.record", kind="admit"),
        _ev(2.3, "journal.replay", records=3),
        _ev(2.4, "serve.dedup", req="r4"),
        _ev(2.5, "compile.start", surface="nvcc"),
        _ev(2.9, "compile.end", surface="nvcc", platform="gpu",
            verdict="cold", dur_s=0.4, cache_new=4),
        _ev(3.0, "compile.end", surface="nvcc", platform="gpu",
            verdict="warm", dur_s=0.01, cache_new=0),
        _ev(3.1, "compile.end", surface="k6", verdict="cold", dur_s=0.2,
            error="RuntimeError: x"),
        _ev(3.2, "warm.end", cold=1, warm=1, failed=0),
        _ev(3.3, "exec.plan", surface="k6", kind="bench",
            timing="chained", phase="device", retry=True),
        _ev(3.4, "exec.launch", surface="k6", kind="bench"),
        _ev(3.5, "exec.done", surface="k6", kind="bench", ok=True,
            wall_s=0.1),
        _ev(3.6, "exec.plan", surface="k7", kind="bench",
            timing="chained", phase="device", retry=True),
        _ev(3.7, "exec.done", surface="k7", kind="bench", ok=False,
            error="RuntimeError", wall_s=0.05),
        _ev(3.8, "exec.select", axis="kernel", choice="k7", static="k6",
            static_choice="k6", reason="race"),
        _ev(3.9, "serve.shard", ranks=8),
        _ev(4.0, "session.end", code=0)],
}


def _write(path: Path, events, torn: bool = False) -> Path:
    lines = [json.dumps(e) for e in events]
    if torn:
        lines.insert(2, '{"t": 1.5, "ev": "hb.ph')     # a torn line
        lines.append("[1, 2]")                          # not an event
    path.write_text("\n".join(lines) + "\n")
    return path


def _close(a, b, where="$"):
    """Equal as JSON, floats within 1e-9."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (where, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (where, a, b)
        else:
            assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9), \
                (where, a, b)
        return
    assert type(a) is type(b), (where, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _normal(obj):
    """JSON round trip: tuples become lists, as on disk."""
    return json.loads(json.dumps(obj))


FUNCTIONS = ("summarize", "chrome_trace", "critical_path", "span_medians",
             "markdown")


def _both(fn: str, path: Path):
    out = []
    for tl, te, cp in ((jax_tl, jax_te, jax_cp),
                       (port_tl, port_te, port_cp)):
        events, torn = tl.read_ledger(path)
        if fn == "summarize":
            res = tl.summarize(path, events, torn)
        elif fn == "chrome_trace":
            res = te.chrome_trace(events)
        elif fn == "critical_path":
            res = cp.compute(events)
        elif fn == "span_medians":
            res = cp.span_medians(events)
        else:
            summary = tl.summarize(path, events, torn)
            res = [tl.summary_markdown(summary),
                   tl.narrative(events, torn, summary)]
        out.append(_normal(res))
    return out


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    port_ledger.disarm()
    yield
    port_ledger.disarm()


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_ledgers_read_the_same(tmp_path, name, fn):
    path = _write(tmp_path / f"{name}.jsonl", FIXTURES[name],
                  torn=name == "sessions")
    jax_out, port_out = _both(fn, path)
    _close(jax_out, port_out)


def test_rotated_ledger_is_read_whole_by_both(tmp_path):
    events = FIXTURES["attribution"]
    path = tmp_path / "rot.jsonl"
    _write(Path(f"{path}.1"), events[:4])
    _write(path, events[4:])
    for fn in FUNCTIONS:
        jax_out, port_out = _both(fn, path)
        _close(jax_out, port_out)
    assert port_tl.read_ledger(path)[0] == jax_tl.read_ledger(path)[0]


# ------------------------------------------------- ledgers the port wrote

def _run(argv, env, timeout=240):
    return subprocess.run([sys.executable, "-m", *argv], cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1", **env},
                          capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture(scope="module")
def port_ledgers(tmp_path_factory):
    """One ledger per port run (module docstring), keyed by run."""
    from tpu_reductions_torch.bench import driver, spot
    from tpu_reductions_torch.faults import inject
    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.request import ReduceRequest
    from tpu_reductions_torch.utils import heartbeat

    d = tmp_path_factory.mktemp("port_ledgers")
    for name in ENV:
        os.environ.pop(name, None)
    out = {}

    def in_process(name, fn):
        path = d / f"{name}.jsonl"
        os.environ["TPU_REDUCTIONS_LEDGER"] = str(path)
        try:
            fn()
        finally:
            port_ledger.disarm()
            heartbeat.reset()
            inject.reset()
            os.environ.pop("TPU_REDUCTIONS_LEDGER", None)
        out[name] = path

    in_process("main_cli", lambda: driver.main(
        ["--method=SUM", "--type=int", "--n=65536", "--platform=cpu",
         f"--logfile={d}/r.txt"]))
    in_process("spot", lambda: spot.main(
        ["--type=int", "--methods=SUM,MIN", "--n=16384", "--iterations=4",
         "--chainreps=2", "--platform=cpu", f"--out={d}/spot.json"]))

    # the stream: cut at its sixth chunk, then resumed from its checkpoint
    led = d / "stream.jsonl"
    argv = ["tpu_reductions_torch.bench.stream", "--method=SUM",
            "--type=int", "--n=262144", "--chunk-bytes=16384",
            "--sync-every=4", "--platform=cpu", f"--out={d}/stream.json"]
    r = _run(argv, {"TPU_REDUCTIONS_LEDGER": str(led),
                    "TPU_REDUCTIONS_FAULTS": json.dumps(
                        {"stream.chunk": {"after": 5, "action": "exit",
                                          "code": 3}})})
    assert r.returncode == 3, r.stderr[-2000:]
    r = _run(argv, {"TPU_REDUCTIONS_LEDGER": str(led)})
    assert r.returncode == 0, r.stderr[-2000:]
    out["stream"] = led

    def serve():
        port_ledger.arm_session("serve", argv=[])
        eng = ServeEngine(coalesce_window_s=0.01, platform="cpu").start()
        try:
            pends = [eng.submit(ReduceRequest(method=m, dtype="int32",
                                              n=4096, seed=s))
                     for s, m in enumerate(("SUM", "MIN", "MAX", "SUM"))]
            assert all(p.result(timeout=60).status == "ok" for p in pends)
        finally:
            eng.stop()
    in_process("serve", serve)

    led = d / "sched.jsonl"
    tasks = [{"name": "row", "value": 2, "budget_s": 120,
              "command": f"{sys.executable} -m tpu_reductions_torch "
                         "--method=MAX --type=float --n=16384 "
                         f"--platform=cpu --logfile={d}/s.txt"},
             {"name": "noop", "value": 1, "budget_s": 60,
              "command": "true"}]
    (d / "tasks.json").write_text(json.dumps(tasks))
    r = _run(["tpu_reductions_torch.sched", f"--tasks={d}/tasks.json",
              f"--state={d}/state.json"],
             {"TPU_REDUCTIONS_LEDGER": str(led)})
    assert r.returncode == 0, r.stderr[-2000:]
    out["sched"] = led
    return out


RUNS = ("main_cli", "spot", "stream", "serve", "sched")


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("run", RUNS)
def test_port_ledgers_read_the_same(port_ledgers, run, fn):
    jax_out, port_out = _both(fn, port_ledgers[run])
    _close(jax_out, port_out)


@pytest.mark.parametrize("run", RUNS)
def test_port_runs_emit_registered_events_only(port_ledgers, run):
    events, torn = port_tl.read_ledger(port_ledgers[run])
    assert events and torn == 0
    names = {e["ev"] for e in events}
    assert names <= REGISTERED_EVENTS, names - REGISTERED_EVENTS


def test_port_runs_carry_what_the_summaries_read(port_ledgers):
    """The summaries are not empty for want of a spelling: each run's
    section is there, with the counts its run implies."""
    def summary(run):
        events, torn = port_tl.read_ledger(port_ledgers[run])
        return port_tl.summarize(port_ledgers[run], events, torn)

    main = summary("main_cli")
    (sess,) = main["sessions"]      # in-process: its end is at exit
    assert sess["prog"] == "tpu_reductions_torch"
    assert sess["phases_s"]["measure"] > 0
    spot_s = summary("spot")
    assert spot_s["exec"]["plans"] == 2 and spot_s["exec"]["failures"] == 0
    stream = summary("stream")
    assert stream["stream"]["streams"] == 2
    assert stream["stream"]["resumed"] == 1
    assert [s["end"] for s in stream["sessions"]] == ["cut", "end"]
    serve_s = summary("serve")["serve"]
    assert serve_s["requests"] == 4 and serve_s["responses"] == 4
    sched = summary("sched")["sched"]
    assert [t["task"] for t in sched["tasks"]] == ["row", "noop"]
    assert all(t["status"] == "done" for t in sched["tasks"])
