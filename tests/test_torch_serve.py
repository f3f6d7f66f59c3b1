"""The port's single-engine serving path against the JAX package's, on
the CPU: request validation, the coalescer and the round planner, the
batch executor's results (int32 and MIN/MAX exact, float SUM within
registry.tolerance), the family's serving batch, the stream route for an
oversized request, a seeded mix through both engines, the engine's
lifecycle (queue full, deadlines, a crash confined to its batch, stop
with and without drain, dedup, prewarm), the seeded open-loop plan, the
TCP front end and its control plane, and the load generator's artifact.

The JAX engines are built with `shard_oversized=False`: this suite gives
JAX eight virtual CPU devices, and one engine on one card never shards,
so both take the stream route."""

import contextlib
import json
import random
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tpu_reductions.faults import inject as jax_inject
from tpu_reductions.ops import registry as jax_registry
from tpu_reductions.serve import coalesce as jax_coalesce
from tpu_reductions.serve import engine as jax_engine
from tpu_reductions.serve import executor as jax_executor
from tpu_reductions.serve import loadgen as jax_loadgen
from tpu_reductions.serve import request as jax_request
from tpu_reductions.serve.transport import NullTransport as JaxNull
from tpu_reductions_torch.faults import inject as port_inject
from tpu_reductions_torch.ops.registry import tolerance
from tpu_reductions_torch.serve import __main__ as port_main
from tpu_reductions_torch.serve import coalesce as port_coalesce
from tpu_reductions_torch.serve import engine as port_engine
from tpu_reductions_torch.serve import executor as port_executor
from tpu_reductions_torch.serve import loadgen as port_loadgen
from tpu_reductions_torch.serve import request as port_request
from tpu_reductions_torch.serve.transport import NullTransport
from torch_routes import both_native  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
METHODS = ("SUM", "MIN", "MAX")
DTYPES = ("int32", "float32", "float64", "bfloat16")


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    monkeypatch.delenv("TPU_REDUCTIONS_FAULTS", raising=False)
    monkeypatch.delenv("TPU_REDUCTIONS_LEDGER", raising=False)
    jax_inject.reset()
    port_inject.reset()
    yield
    jax_inject.reset()
    port_inject.reset()


def _jax_engine(**kw):
    return jax_engine.ServeEngine(transport=JaxNull(), shard_oversized=False,
                                  **kw)


def _port_engine(**kw):
    return port_engine.ServeEngine(transport=NullTransport(),
                                   platform="cpu", **kw)


def _close(got: dict, want: dict, method: str, dtype: str, n: int) -> None:
    """One result of each side: the same verdict, and the same value
    (exact for ints and MIN/MAX, within the tolerance for float SUM)."""
    assert got["ok"] is want["ok"] is True
    assert got["host"] == want["host"]
    tol = tolerance(method, dtype, n)
    assert tol == jax_registry.tolerance(method, dtype, n)
    if tol == 0.0:
        assert got["result"] == want["result"]
    else:
        assert abs(got["result"] - want["result"]) <= tol


# ------------------------------------------------------------ requests

@pytest.mark.parametrize("kw", [
    dict(method="PROD", dtype="int", n=4),
    dict(method="SUM", dtype="int64", n=4),
    dict(method="SUM", dtype="int", n=0),
    dict(method="SUM", dtype="int", n=4, deadline_s=0),
    dict(method="SUM", dtype="int", n=4, value=0),
    dict(method="SUM", dtype="int", n=4, tenant=""),
    dict(method="SUM", dtype="int", n=4, priority=-1),
    dict(method="SUM", dtype="int", n=4, slo=""),
    dict(method="SUM", dtype="int", n=4, idem_key=""),
], ids=["method", "dtype", "n", "deadline", "value", "tenant", "priority",
        "slo", "idem"])
def test_request_validation_refuses_with_jax_words(kw):
    msgs = []
    for mod in (jax_request, port_request):
        with pytest.raises(ValueError) as e:
            mod.ReduceRequest(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("dtype", ["int", "float", "double", "bfloat16",
                                   "float32"])
def test_request_fields_and_bytes_match_jax(dtype):
    a = jax_request.ReduceRequest(method="scan", dtype=dtype, n=1000, seed=3)
    b = port_request.ReduceRequest(method="scan", dtype=dtype, n=1000,
                                   seed=3)
    assert (b.method, b.dtype, b.n, b.seed, b.nbytes) == \
        (a.method, a.dtype, a.n, a.seed, a.nbytes)
    r = port_request.ReduceResponse("r1", "ok", "SUM", "int32", 4, 1.0)
    assert r.to_dict() == jax_request.ReduceResponse(
        "r1", "ok", "SUM", "int32", 4, 1.0).to_dict()


def test_pending_response_times_out_and_resolves_once():
    p = port_request.PendingResponse("r9")
    with pytest.raises(TimeoutError, match="r9 unresolved after 0.01s"):
        p.result(timeout=0.01)
    seen = []
    p.add_done_callback(seen.append)
    first = port_request.ReduceResponse("r9", "ok", "SUM", "int32", 1)
    p.resolve(first)
    p.resolve(port_request.ReduceResponse("r9", "error", "SUM", "int32", 1))
    assert p.done() and p.result(0) is first and seen == [first]
    p.add_done_callback(seen.append)
    assert seen == [first, first]


# ------------------------------------------------------------ coalescing

class _Adm:
    def __init__(self, request, rid):
        self.request, self.request_id = request, rid


def _mix(mod, seed: int, count: int = 40) -> list:
    rng = random.Random(seed)
    out = []
    for i in range(count):
        out.append(_Adm(mod.ReduceRequest(
            method=rng.choice(("SUM", "MIN", "SCAN")),
            dtype=rng.choice(("int", "float")),
            n=rng.choice((64, 1000, 1 << 16)), seed=i,
            value=rng.choice((0.5, 1.0, 3.0))), f"r{i:06d}"))
    return out


def _batches(batches) -> list:
    return [(b.key, [a.request_id for a in b.admitted], b.value, b.nbytes)
            for b in batches]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_batch,max_bytes", [(32, 512 << 20), (3, 1 << 20),
                                                 (8, 300_000)])
def test_coalesce_and_plan_round_match_jax(seed, max_batch, max_bytes):
    sides = {}
    for name, req, co in (("jax", jax_request, jax_coalesce),
                          ("port", port_request, port_coalesce)):
        batches = co.coalesce(_mix(req, seed), max_batch=max_batch,
                              max_batch_bytes=max_bytes)
        cm = co.CostModel(alpha=0.5, default_s=0.01)
        for i, b in enumerate(batches):
            if i % 2:
                cm.observe(b.key, 0.002 * (i + 1))
                cm.observe(b.key, 0.001)
        launch, defer = co.plan_round(batches, cost_model=cm,
                                      device_window_s=0.02)
        ids = {b.batch_id: i for i, b in enumerate(batches)}
        sides[name] = (_batches(batches),
                       [ids[b.batch_id] for b in launch],
                       [ids[b.batch_id] for b in defer],
                       [cm.estimate(b.key) for b in batches])
    assert sides["port"] == sides["jax"]
    assert sides["port"][1], "the top pick always launches"
    assert port_coalesce.plan_round([], cost_model=port_coalesce.CostModel(),
                                    device_window_s=1.0) == ([], [])
    with pytest.raises(ValueError, match="alpha"):
        port_coalesce.CostModel(alpha=0)


# ------------------------------------------------------------ the executor

@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("n", [3, 1000, 1 << 16])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
def test_run_batch_matches_jax(method, dtype, n, k, both_native):
    seeds = [7 * i + k for i in range(k)]
    want = jax_executor.BatchExecutor().run_batch(method, dtype, n, seeds)
    ex = port_executor.BatchExecutor("cpu")
    got = ex.run_batch(method, dtype, n, seeds)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        _close(g, w, method, dtype, n)
    assert ex.launches == {f"serve-bucket/{method.lower()}": 1}
    assert set(ex.seconds) == set(port_executor.STEPS)
    assert ex.last_route == "pageable"


def test_capabilities_on_one_device():
    caps = port_executor.BatchExecutor("cpu").capabilities()
    assert caps == {"backend": "cpu", "supports_f64": True,
                    "device_count": 1, "cards": 1}
    # one rank: the shard route is the stream, as in JAX on one device
    ex = port_executor.BatchExecutor("cpu")
    got = ex.run_sharded("SUM", "int32", 4, 0)
    want = ex.run_stream("SUM", "int32", 4, 0)
    assert {k: got[k] for k in ("result", "ok", "host", "chunks")} == \
        {k: want[k] for k in ("result", "ok", "host", "chunks")}
    assert "devices" not in got


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("method,dtype", [("SCAN", "float32"),
                                          ("SEGSUM", "int32"),
                                          ("ARGMAX", "float32"),
                                          ("SCAN", "int32"),
                                          ("SEGMIN", "float32"),
                                          ("ARGMIN", "int32")])
def test_family_batch_matches_jax(method, dtype, k, both_native):
    n = 4096
    seeds = list(range(3, 3 + k))
    want = jax_executor.BatchExecutor().run_batch(method, dtype, n, seeds)
    got = port_executor.BatchExecutor("cpu").run_batch(method, dtype, n,
                                                       seeds)
    for g, w in zip(got, want):
        _close(g, w, "SUM" if method in ("SCAN", "SEGSUM") else method,
               dtype, n)


@pytest.mark.parametrize("method,dtype", [("SUM", "int32"),
                                          ("MAX", "float32"),
                                          ("SUM", "float64"),
                                          ("SCAN", "float32")])
def test_oversized_request_streams_like_jax(method, dtype, both_native):
    n = 50_000
    kw = dict(max_request_bytes=64 << 10, stream_chunk_bytes=32 << 10,
              coalesce_window_s=0.0)
    resps = {}
    for name, mod, eng in (("jax", jax_request, _jax_engine(**kw)),
                           ("port", port_request, _port_engine(**kw))):
        eng.start()
        try:
            r = eng.submit(mod.ReduceRequest(method=method, dtype=dtype,
                                             n=n, seed=5)).result(60)
        finally:
            eng.stop()
        resps[name] = r
        assert eng.stats["batches"] == 1 and eng.stats["sharded"] == 0
    for r in resps.values():
        assert (r.status, r.batch_size) == ("ok", 1), r.error
    tol = tolerance("SUM" if method == "SCAN" else method, dtype, n)
    assert abs(resps["port"].result - resps["jax"].result) <= tol


def test_family_without_a_stream_is_refused_like_jax():
    for ex in (jax_executor.BatchExecutor(),
               port_executor.BatchExecutor("cpu")):
        with pytest.raises(ValueError, match="SEGSUM has no streaming path"):
            ex.run_stream("SEGSUM", "int32", 100, 0)


# ------------------------------------------------------------ the engines

def _seeded_mix(mod, seed: int = 11, count: int = 36) -> list:
    rng = random.Random(seed)
    reqs = []
    for i in range(count):
        method = rng.choice(("SUM", "MIN", "MAX", "SUM", "SCAN", "SEGMAX",
                             "ARGMIN"))
        dtype = rng.choice(("int", "float") if method not in METHODS
                           else ("int", "float", "double", "bfloat16"))
        reqs.append(mod.ReduceRequest(method=method, dtype=dtype,
                                      n=rng.choice((100, 4096)),
                                      seed=rng.randrange(1000)))
    return reqs


def _serve_all(eng, reqs, timeout=120):
    pends = [eng.submit(r) for r in reqs]     # queued before start
    eng.start()
    try:
        return [p.result(timeout) for p in pends]
    finally:
        eng.stop()


def test_seeded_mix_through_both_engines(both_native):
    j = _serve_all(_jax_engine(max_batch=4), _seeded_mix(jax_request))
    p_eng = _port_engine(max_batch=4)
    p = _serve_all(p_eng, _seeded_mix(port_request))
    assert [r.status for r in p] == [r.status for r in j] == ["ok"] * 36
    for a, b in zip(p, j):
        assert (a.method, a.dtype, a.n, a.batch_size) == \
            (b.method, b.dtype, b.n, b.batch_size)
        m = "SUM" if a.method == "SCAN" else a.method
        tol = tolerance(m, a.dtype, a.n)
        if a.method == "SEGMAX":
            tol = tolerance("SUM", a.dtype, a.n)
        assert abs(a.result - b.result) <= tol, (a, b)
    assert p_eng.stats["batches"] == p_eng._executor.launches.total()


def test_queue_full_and_priority_preemption_match_jax():
    out = {}
    for name, mod, eng in (("jax", jax_request,
                            _jax_engine(max_queue=2, tenant_quota=5)),
                           ("port", port_request,
                            _port_engine(max_queue=2, tenant_quota=5))):
        ps = [eng.submit(mod.ReduceRequest(method="SUM", dtype="int", n=8,
                                           seed=i, priority=pr))
              for i, pr in enumerate((1, 1, 1, 2, 0))]
        got = [(p.result(0).status, p.result(0).error) if p.done() else
               None for p in ps]
        eng.stop(drain=False)
        out[name] = (got, [p.result(5).status for p in ps],
                     dict(eng.stats))
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["shed", "shed", "rejected", "shed",
                              "rejected"]


def test_admission_refusals_match_jax():
    out = {}
    for name, mod, eng in (("jax", jax_request,
                            _jax_engine(tenant_quota=1,
                                        max_request_bytes=1024,
                                        stream_oversized=False,
                                        slo_classes={"std": 1.0})),
                           ("port", port_request,
                            _port_engine(tenant_quota=1,
                                         max_request_bytes=1024,
                                         stream_oversized=False,
                                         slo_classes={"std": 1.0}))):
        reqs = [mod.ReduceRequest(method="SUM", dtype="int", n=8),
                mod.ReduceRequest(method="SUM", dtype="int", n=8),
                mod.ReduceRequest(method="SUM", dtype="int", n=4096,
                                  tenant="b"),
                mod.ReduceRequest(method="SUM", dtype="int", n=8,
                                  slo="gold", tenant="c")]
        ps = [eng.submit(r) for r in reqs]
        eng.begin_drain()
        ps.append(eng.submit(mod.ReduceRequest(method="SUM", dtype="int",
                                               n=8, tenant="d")))
        out[name] = [(p.result(0).status, p.result(0).error)
                     if p.done() else None for p in ps]
        eng.stop(drain=False)
        assert eng.draining
    assert out["port"] == out["jax"]
    assert [o and o[0] for o in out["port"]] == [
        None, "rejected", "rejected", "rejected", "rejected"]


def test_deadline_expiry_in_the_queue():
    for mod, eng in ((jax_request, _jax_engine()),
                     (port_request, _port_engine())):
        p = eng.submit(mod.ReduceRequest(method="SUM", dtype="int", n=8,
                                         deadline_s=0.01))
        time.sleep(0.05)
        eng.start()
        r = p.result(10)
        eng.stop()
        assert (r.status, r.error) == ("expired", "deadline passed in queue")


def test_a_crash_is_confined_to_its_batch(monkeypatch):
    monkeypatch.setenv("TPU_REDUCTIONS_FAULTS", json.dumps(
        {"serve.batch": {"times": 1, "message": "scripted crash"}}))
    out = {}
    for name, mod, eng in (("jax", jax_request, _jax_engine()),
                           ("port", port_request, _port_engine())):
        reqs = [mod.ReduceRequest(method=m, dtype="int", n=64, seed=i)
                for i, m in enumerate(("SUM", "SUM", "MAX"))]
        rs = _serve_all(eng, reqs)
        out[name] = [(r.status, r.error) for r in rs]
    assert out["port"] == out["jax"]
    assert out["port"][0] == ("error", "InjectedFault: scripted crash")
    assert out["port"][2][0] == "ok"


def test_stop_with_and_without_drain():
    for drain in (True, False):
        out = {}
        for name, mod, eng in (("jax", jax_request, _jax_engine()),
                               ("port", port_request, _port_engine())):
            ps = [eng.submit(mod.ReduceRequest(method="SUM", dtype="int",
                                               n=8, seed=i))
                  for i in range(3)]
            eng.stop(drain=drain)
            eng.stop()                      # idempotent
            late = eng.submit(mod.ReduceRequest(method="SUM", dtype="int",
                                                n=8))
            out[name] = ([(p.result(1).status, p.result(1).error)
                          for p in ps], late.result(1).error)
        assert out["port"] == out["jax"]
        assert out["port"][1] == "engine-stopped"
    # a running engine drains what it holds
    eng = _port_engine()
    eng.start()
    ps = [eng.submit(port_request.ReduceRequest(method="SUM", dtype="int",
                                                n=8, seed=i))
          for i in range(4)]
    eng.stop(drain=True)
    assert all(p.result(5).status in ("ok", "shed") for p in ps)


def test_dedup_answers_a_settled_key_once():
    for mod, eng in ((jax_request, _jax_engine()),
                     (port_request, _port_engine())):
        eng.start()
        first = eng.submit(mod.ReduceRequest(method="SUM", dtype="int",
                                             n=64, seed=4,
                                             idem_key="k1")).result(10)
        again = eng.submit(mod.ReduceRequest(method="SUM", dtype="int",
                                             n=64, seed=99,
                                             idem_key="k1")).result(10)
        eng.stop()
        assert first.status == "ok" and again is first
        assert (eng.stats["dedup_hits"], eng.stats["batches"]) == (1, 1)


def test_prewarm_and_warm_keys():
    eng = _port_engine()
    ex = port_executor.BatchExecutor("cpu")
    eng._executor = ex
    eng.prewarm("SUM", "int", 512, up_to_batch=5)
    assert eng.warm_bucket_keys() == [("SUM", "int32", 512)]
    assert ex.launches == {"serve-bucket/sum": 4}     # buckets 1, 2, 4, 8
    assert eng.stats["batches"] == 0
    j = _jax_engine()
    j.prewarm("SUM", "int32", 512, up_to_batch=5)
    assert j.warm_bucket_keys() == eng.warm_bucket_keys()


def test_p99_over_slo_sheds_at_admission():
    eng = _port_engine(slo_classes={"std": 0.5}, slo_min_samples=2)
    for _ in range(3):
        eng._slo.observe("std", 2.0)
    assert eng.slo_p99("std") == 2.0
    r = eng.submit(port_request.ReduceRequest(method="SUM", dtype="int",
                                              n=8, slo="std")).result(0)
    assert r.status == "shed" and r.error.startswith("p99-over-slo")
    eng.stop(drain=False)


# ------------------------------------------------------------ loadgen

@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_plan_workload_is_the_jax_plan(process):
    kw = dict(count=57, methods=["SUM", "MIN", "MAX"], dtype="int",
              n_choices=[1024, 65536], rate_rps=40.0, process=process,
              burst=5, deadline_s=2.0, slo="std")
    want = jax_loadgen.plan_workload(13, **kw)
    got = port_loadgen.plan_workload(13, **kw)
    assert [(o, r.method, r.dtype, r.n, r.seed, r.deadline_s, r.slo)
            for o, r in got] == \
        [(o, r.method, r.dtype, r.n, r.seed, r.deadline_s, r.slo)
         for o, r in want]
    assert port_loadgen.diurnal_epoch_counts(57) == \
        jax_loadgen.diurnal_epoch_counts(57)
    with pytest.raises(ValueError, match="unknown arrival process"):
        port_loadgen.open_arrivals(random.Random(0), count=1, rate_rps=1,
                                   process="x")


def test_open_loop_resolves_every_request():
    eng = _port_engine(coalesce_window_s=0.001).start()
    plan = port_loadgen.plan_workload(
        3, count=24, methods=["SUM", "MAX"], dtype="int",
        n_choices=[256], rate_rps=2000.0, process="bursty", burst=8)
    try:
        row = port_loadgen.run_open_load(eng.submit, plan, timeout_s=60)
    finally:
        eng.stop()
    assert row["requests"] == row["ok"] == 24
    assert {"wall_s", "rps", "by_status", "mean_batch", "p50_ms",
            "p99_ms"} <= set(row)


def test_percentile_and_curve_markdown_match_jax():
    vals = sorted(random.Random(2).random() for _ in range(101))
    for q in (0.0, 0.5, 0.99, 1.0):
        assert port_loadgen.percentile(vals, q) == \
            jax_loadgen.percentile(vals, q)
    art = {"dtype": "int32", "n": 64, "methods": "SUM", "platform": "cpu",
           "launch_latency_ms": 0.0,
           "rows": [{"mode": "coalesced", "clients": 2, "requests": 4,
                     "rps": 10.0, "p50_ms": 1.0, "p99_ms": 2.0,
                     "mean_batch": 2.0, "ok": 3,
                     "by_status": {"ok": 3, "expired": 1}},
                    {"mode": "sequential", "clients": 2, "requests": 4,
                     "rps": 5.0, "ok": 4, "by_status": {"ok": 4}}]}
    assert port_loadgen.curve_markdown(art) == jax_loadgen.curve_markdown(art)


def test_loadgen_writes_jax_columns_and_resumes(tmp_path, capsys):
    argv = ["--clients=3", "--requests=4", "--n=256", "--seed=2"]
    jax_out, out = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_loadgen.main(argv + ["--platform=cpu",
                                    "--launch-latency-ms=0",
                                    f"--out={jax_out}"]) == 0
    assert port_loadgen.main(argv + ["--platform=cpu", f"--out={out}"]) == 0
    text = capsys.readouterr().out
    jd, pd = json.loads(jax_out.read_text()), json.loads(out.read_text())
    assert set(jd) == set(pd) and pd["complete"] is True
    assert [r["mode"] for r in pd["rows"]] == ["coalesced", "sequential"]
    for jr, pr in zip(jd["rows"], pd["rows"]):
        assert set(jr) <= set(pr)
        assert pr["ok"] == pr["requests"] == 12
        assert pr["batches"] == pr["launches"] > 0
        assert set(pr["seconds"]) == set(port_executor.STEPS)
    assert "coalescing speedup" in text
    # an interrupted artifact: its measured row is reused
    pd["complete"] = False
    pd["rows"] = pd["rows"][:1]
    out.write_text(json.dumps(pd))
    assert port_loadgen.main(argv + ["--platform=cpu", f"--out={out}"]) == 0
    err = capsys.readouterr().err
    assert "loadgen coalesced: resumed from prior artifact" in err
    assert "sequential: resumed" not in err
    assert json.loads(out.read_text())["rows"][0] == pd["rows"][0]


@pytest.mark.parametrize("argv,words", [
    (["--scale", "--connect=h:1"], "--scale drives in-process"),
    (["--elastic", "--connect=h:1"], "--elastic drives in-process"),
    (["--recovery", "--connect=h:1"], "--recovery drives its own router"),
    (["--launch-latency-ms=-1"], "--launch-latency-ms must be >= 0"),
    (["--methods=SCAN"], "--methods must name only"),
    (["--type=int64"], "unknown --type")])
def test_loadgen_refusals(argv, words, capsys):
    with pytest.raises(SystemExit) as e:
        port_loadgen.main(argv + ["--platform=cpu"])
    assert e.value.code == 2
    assert words in capsys.readouterr().err


# ------------------------------------------------------------ TCP

def _ask(port: int, lines: list) -> list:
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        f = s.makefile("r")
        out = []
        for spec in lines:
            s.sendall((json.dumps(spec) + "\n").encode())
            out.append(json.loads(f.readline()))
        return out


def _wait_port(path: Path, proc=None, timeout: float = 60) -> int:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if path.exists() and path.read_text().strip():
            return int(path.read_text())
        if proc is not None and proc.poll() is not None:
            raise AssertionError(proc.stderr.read())
        time.sleep(0.05)
    raise AssertionError("the server never wrote its port")


REQUEST = {"method": "SUM", "type": "float", "n": 65536, "seed": 3}


def test_tcp_round_trip_and_control_plane(tmp_path, both_native):
    """`python -m tpu_reductions_torch.serve --platform=cpu` answers a
    request with the JAX front end's result, and its control plane."""
    pf = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_reductions_torch.serve",
         "--platform=cpu", "--port=0", f"--port-file={pf}",
         "--max-seconds=30"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    from tpu_reductions.serve import __main__ as jax_main
    try:
        port = _wait_port(pf, proc)
        got = _ask(port, [REQUEST, {"op": "ping"},
                          {"op": "prewarm", "method": "MAX", "type": "int",
                           "n": 128, "up_to_batch": 2},
                          {"op": "drain_status"}, {"op": "bogus"},
                          {"method": "NOPE"}, {"op": "drain"},
                          REQUEST])
        with _front_end(jax_main, _jax_engine()) as jax_port:
            want = _ask(jax_port, [REQUEST])[0]
    finally:
        proc.terminate()
        proc.wait(30)
    ok, ping, prewarm, status, bogus, bad, drain, after = got
    assert ok["status"] == want["status"] == "ok"
    assert ok["result"] == want["result"]
    assert set(ok) == set(want)
    assert ping == {"op": "ping", "ok": True}
    assert prewarm == {"op": "prewarm", "ok": True}
    assert status["ok"] and not status["draining"]
    assert status["warm_keys"] == [["MAX", "int32", 128],
                                   ["SUM", "float32", 65536]]
    assert status["stats"]["ok"] == 1
    assert bogus["error"] == "unknown control op: 'bogus'"
    assert bad["status"] == "rejected" and "malformed request" in bad["error"]
    assert drain == {"op": "drain", "ok": True}
    assert after["status"] == "rejected"
    assert after["error"].startswith("replica-draining")


@contextlib.contextmanager
def _front_end(main_mod, engine):
    """A package's TCP front end (its _Server and handler) over `engine`,
    on a port from the OS, shut down on exit."""
    engine.start()
    server = main_mod._Server(("127.0.0.1", 0),
                              main_mod._make_handler(engine, 60.0))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        t.join(10)
        engine.stop()


def test_tcp_submit_drives_the_front_end():
    with _front_end(port_main, _port_engine(
            coalesce_window_s=0.001)) as port:
        row = port_loadgen.run_load(
            port_loadgen._tcp_submit(f"127.0.0.1:{port}"), clients=3,
            requests=4, methods=["SUM", "MIN"], dtype="int", n=512, seed=1)
    assert row["requests"] == row["ok"] == 12 and row["clients"] == 3


def test_control_response_reports_errors():
    eng = _port_engine()
    assert port_main._control_response(eng, {"op": "prewarm"})[
        "error"].startswith("KeyError")
    assert port_main._control_response(eng, {"op": None}) == {
        "op": None, "error": "unknown control op: None"}
    eng.stop(drain=False)


def test_regen_folds_the_serving_curve_and_the_decisions(tmp_path):
    from tpu_reductions_torch.bench import regen
    from tpu_reductions_torch.exec import __main__ as explain
    from tpu_reductions_torch.exec.cost import CostOracle, decisions_markdown
    curve = {"dtype": "int32", "n": 64, "methods": "SUM",
             "rows": [{"mode": "coalesced", "clients": 2, "requests": 4,
                       "rps": 10.0, "ok": 4, "by_status": {"ok": 4},
                       "mean_batch": 2.0}]}
    decisions = {"rows": explain.decision_rows(CostOracle(str(tmp_path)))}
    (tmp_path / "shmoo.json").write_text("[]")
    (tmp_path / "serving_curve.json").write_text(json.dumps(curve))
    (tmp_path / "exec_decisions.json").write_text(json.dumps(decisions))
    logs = []
    assert regen.regenerate(tmp_path, log=logs.append)
    md = (tmp_path / "report.md").read_text()
    assert port_loadgen.curve_markdown(curve) in md
    assert decisions_markdown(decisions) in md
    assert any("serving_curve" in m for m in logs)
    assert any("exec_decisions" in m for m in logs)
