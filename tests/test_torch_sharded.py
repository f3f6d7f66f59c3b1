"""The port's shard route against the JAX package's, on the CPU: the port's
BatchExecutor at ranks=8 (eight rows of one tensor) against JAX's on its
eight virtual CPU devices (tests/conftest.py). int32 SUM (wrapping), MIN
and MAX give JAX's exact values at n = 2^16 with chunk_bytes = 2^14 and at
ragged sizes, float32 and bfloat16 SUM within registry.tolerance, the
quantized combine selects JAX's algorithm and wire factor and stays within
its declared bound, float64 and the family are refused with the JAX
words, SCAN and one rank take the stream, and the engine sends an
oversized request through the route, with `serve.shard`,
`collective.select`, `collective.launch` and `collective.done` in the
port's ledger."""

import json

import pytest

from tpu_reductions.faults import inject as jax_inject
from tpu_reductions.ops import registry as jax_registry
from tpu_reductions.serve import engine as jax_engine
from tpu_reductions.serve import executor as jax_executor
from tpu_reductions.serve import request as jax_request
from tpu_reductions_torch.faults import inject as port_inject
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.ops.registry import tolerance
from tpu_reductions_torch.serve import engine as port_engine
from tpu_reductions_torch.serve import executor as port_executor
from tpu_reductions_torch.serve import request as port_request
from torch_routes import both_native  # noqa: F401

SELECTION = ("algorithm", "wire_factor", "quantized", "devices",
             "per_device_chunks", "chunk_bytes")


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    monkeypatch.delenv("TPU_REDUCTIONS_FAULTS", raising=False)
    monkeypatch.delenv("TPU_REDUCTIONS_LEDGER", raising=False)
    jax_inject.reset()
    port_inject.reset()
    yield
    jax_inject.reset()
    port_inject.reset()


@pytest.fixture(scope="module")
def jax_ex():
    return jax_executor.BatchExecutor()


def _pair(jax_ex, method, dtype, n, seed, **kw):
    want = jax_ex.run_sharded(method, dtype, n, seed, **kw)
    port = port_executor.BatchExecutor("cpu", ranks=8)
    got = port.run_sharded(method, dtype, n, seed, **kw)
    return got, want, port


@pytest.mark.parametrize("n", [1 << 16, 65537, 100_003])
@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
def test_int32_is_exactly_jax(jax_ex, method, n, both_native):
    got, want, port = _pair(jax_ex, method, "int32", n, 3,
                            chunk_bytes=1 << 14)
    assert got["ok"] is want["ok"] is True
    assert got["result"] == want["result"] == want["host"] == got["host"]
    assert {k: got[k] for k in SELECTION} == {k: want[k] for k in SELECTION}
    assert got["devices"] == 8 and got["per_device_chunks"] >= 2
    assert got["note"] == "the 8 ranks are rows of one tensor on cpu"
    assert port.launches == {f"serve-shard/{method.lower()}": 1}
    assert set(port.last_shard) == {"fill", "fold", "fold_cards", "gather",
                                    "combine", "verify"}
    assert got["cards"] == 1 and len(port.last_shard["fold_cards"]) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
def test_float_is_jax_within_tolerance(jax_ex, method, dtype, both_native):
    n = 1 << 16
    got, want, _ = _pair(jax_ex, method, dtype, n, 5, chunk_bytes=1 << 14)
    assert got["ok"] is want["ok"] is True
    assert got["host"] == want["host"]
    tol = tolerance(method, dtype, n)
    assert tol == jax_registry.tolerance(method, dtype, n)
    assert abs(got["result"] - want["result"]) <= tol
    if tol == 0.0:
        assert got["result"] == want["result"]
    assert {k: got[k] for k in SELECTION} == {k: want[k] for k in SELECTION}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("chunk_bytes", [1 << 14, 1 << 16])
def test_quantized_selects_jax_algorithm_within_bound(jax_ex, bits,
                                                      chunk_bytes,
                                                      both_native):
    got, want, _ = _pair(jax_ex, "SUM", "float32", 1 << 16, 5,
                         quantized=True, quant_bits=bits,
                         chunk_bytes=chunk_bytes)
    assert got["ok"] is want["ok"] is True
    assert got["quantized"] is want["quantized"] is True
    assert {k: got[k] for k in SELECTION} == {k: want[k] for k in SELECTION}
    assert got["algorithm"].startswith(f"q{bits}_")
    assert got["wire_factor"] < 1.0
    if got["quant_bound"] is not None:
        assert got["diff"] <= got["quant_bound"]


def test_quantized_int_falls_back_to_the_exact_wire(jax_ex, both_native):
    got, want, _ = _pair(jax_ex, "SUM", "int32", 1 << 16, 2,
                         quantized=True, chunk_bytes=1 << 14)
    assert got["quantized"] is want["quantized"] is False
    assert got["result"] == want["result"]
    assert got["algorithm"] == want["algorithm"]


@pytest.mark.parametrize("method,dtype", [("SUM", "float64"),
                                          ("SEGSUM", "int32"),
                                          ("ARGMAX", "float32")])
def test_refusals_use_the_jax_words(jax_ex, method, dtype):
    msgs = []
    for ex in (jax_ex, port_executor.BatchExecutor("cpu", ranks=8)):
        with pytest.raises(ValueError) as e:
            ex.run_sharded(method, dtype, 1 << 16, 0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_scan_and_one_rank_take_the_stream(both_native):
    ex = port_executor.BatchExecutor("cpu", ranks=8)
    scan = ex.run_sharded("SCAN", "int32", 1 << 16, 1, chunk_bytes=1 << 14)
    assert scan["ok"] and "chunks" in scan and "devices" not in scan
    one = port_executor.BatchExecutor("cpu").run_sharded(
        "SUM", "int32", 1 << 16, 1, chunk_bytes=1 << 14)
    assert one["ok"] and "devices" not in one
    assert ex.run_sharded("SUM", "int32", 1 << 16, 1, devices=1,
                          chunk_bytes=1 << 14)["result"] == one["result"]
    assert ex.run_sharded("SUM", "int32", 1 << 16, 1, devices=4,
                          chunk_bytes=1 << 14)["devices"] == 4
    assert ex.run_sharded("MIN", "int32", 3, 1)["devices"] == 3   # k <= n


def test_capabilities_report_the_ranks():
    assert port_executor.BatchExecutor("cpu").capabilities()[
        "device_count"] == 1
    assert port_executor.BatchExecutor("cpu", ranks=8).capabilities()[
        "device_count"] == 8
    with pytest.raises(ValueError, match="ranks must be >= 1"):
        port_executor.BatchExecutor("cpu", ranks=0)


class _Caps:
    def __init__(self, device_count):
        self._n = device_count

    def capabilities(self):
        return {"backend": "cpu", "supports_f64": True,
                "device_count": self._n}


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("dtype,n", [("int", 1 << 12), ("int", 64),
                                     ("double", 1 << 12),
                                     ("bfloat16", 1 << 12)])
def test_should_shard_gates_like_jax(devices, dtype, n):
    verdicts = []
    for eng_mod, req_mod in ((jax_engine, jax_request),
                             (port_engine, port_request)):
        eng = eng_mod.ServeEngine(executor=_Caps(devices),
                                  shard_threshold_bytes=1 << 10)
        adm = eng_mod._Admitted(
            request=req_mod.ReduceRequest(method="SUM", dtype=dtype, n=n),
            request_id="r0", pending=None, t_enqueue=0.0, t_deadline=None)
        verdicts.append(eng._should_shard(adm))
    assert verdicts[0] == verdicts[1]


def test_engine_sends_an_oversized_request_through_the_route(tmp_path,
                                                              both_native):
    led = tmp_path / "ledger.jsonl"
    ledger.arm(str(led))
    try:
        ex = port_executor.BatchExecutor("cpu", ranks=8)
        eng = port_engine.ServeEngine(executor=ex, coalesce_window_s=0.0,
                                      shard_threshold_bytes=1 << 20,
                                      platform="cpu").start()
        n = 1 << 19                  # 2 MiB of int32: over the 1 MiB line
        r = eng.submit(port_request.ReduceRequest(
            method="SUM", dtype="int", n=n, seed=11)).result(timeout=120)
        eng.stop()
    finally:
        ledger.disarm()
    want = jax_executor.BatchExecutor().run_sharded("SUM", "int32", n, 11)
    assert r.status == "ok", (r.status, r.error)
    assert r.result == want["result"]
    assert eng.stats["sharded"] == 1
    events = [json.loads(line) for line in led.read_text().splitlines()]
    names = [e["ev"] for e in events]
    for ev in ("serve.shard", "collective.select", "collective.launch",
               "collective.done"):
        assert ev in names, ev
    sel = next(e for e in events if e["ev"] == "collective.select")
    assert sel["algorithm"] == want["algorithm"] and sel["ranks"] == 8
    verify = next(e for e in events if e["ev"] == "serve.verify")
    assert verify["devices"] == 8
