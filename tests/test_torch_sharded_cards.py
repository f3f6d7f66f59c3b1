"""The serving shard route across the host's cards, on the CPU.

`device.rank_blocks` places K ranks on C cards in contiguous, rank-ordered
blocks; `device.cards` lists the host's cards without making a context.
`BatchExecutor(cards=[cpu] * C)` runs the route's per-card grouping, the
per-card folds (one host thread a card) and the gather with C entries of
the CPU device: for every method and dtype it gives the port's one-card
bits at the same K, and against JAX's `run_sharded` at the same k on its
virtual devices (tests/conftest.py) int32 SUM, MIN and MAX are exact,
float32 and bfloat16 SUM within `registry.tolerance`, and the quantized
combine selects JAX's algorithm and wire factor. The engine takes an
oversized request through the route with `cards` in `serve.shard`,
`serve.verify` and the response, and a failing card fails the request.
"""

import json

import jax
import pytest
import torch

from tpu_reductions.faults import inject as jax_inject
from tpu_reductions.serve import executor as jax_executor
from tpu_reductions_torch import device
from tpu_reductions_torch.faults import inject as port_inject
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.ops.registry import tolerance
from tpu_reductions_torch.ops.stream import plan_chunks
from tpu_reductions_torch.serve import engine as port_engine
from tpu_reductions_torch.serve import executor as port_executor
from tpu_reductions_torch.serve import request as port_request
from torch_routes import both_native  # noqa: F401

CPU = torch.device("cpu")
NS = (1 << 16, 65537, 100_003)
CHUNK_BYTES = 1 << 14
PAIRS = [(m, d) for d in ("int32", "float32", "bfloat16")
         for m in ("SUM", "MIN", "MAX")]
SAME = ("result", "host", "diff", "ok", "algorithm", "wire_factor",
        "quantized", "quant_bound", "devices", "per_device_chunks",
        "chunk_bytes")
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


# ---------------------------------------------------------------- placement

@pytest.mark.parametrize("cards", [1, 2, 3, 4])
@pytest.mark.parametrize("ranks", [2, 3, 4, 8])
def test_rank_blocks_are_contiguous_and_rank_ordered(ranks, cards):
    blocks = device.rank_blocks(ranks, cards)
    used = min(ranks, cards)
    assert len(blocks) == used
    assert [r for b in blocks for r in b] == list(range(ranks))
    for c, b in enumerate(blocks):
        assert b == range(c * ranks // used, (c + 1) * ranks // used)
        assert len(b) >= 1
    assert max(map(len, blocks)) - min(map(len, blocks)) <= 1


def test_rank_blocks_refuse_an_empty_side():
    for ranks, cards in ((0, 2), (2, 0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            device.rank_blocks(ranks, cards)


def test_cards_lists_the_host_cards_without_a_context(monkeypatch):
    assert device.cards("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)

    def no_context(*_a, **_k):
        raise AssertionError("device.cards made a CUDA context")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_context)
    monkeypatch.setattr(torch.cuda, "init", no_context)
    assert device.cards("gpu") == [torch.device("cuda", i)
                                   for i in range(3)]
    with pytest.raises(ValueError, match="platform must be one of"):
        device.cards("tpu")


def test_executor_takes_its_cards():
    assert port_executor.BatchExecutor("cpu").cards == [CPU]
    ex = port_executor.BatchExecutor("cpu", ranks=8, cards=["cpu"] * 3)
    assert ex.cards == [CPU] * 3
    assert ex.capabilities() == {"backend": "cpu", "supports_f64": True,
                                 "device_count": 8, "cards": 3}
    assert port_executor.BatchExecutor("cpu").capabilities()["cards"] == 1
    with pytest.raises(ValueError, match="cards must name"):
        port_executor.BatchExecutor("cpu", cards=[])


# ------------------------------------------------------ the route, one card

_one_card: dict = {}


def _one(method, dtype, n, k, **kw):
    """The port's one-card response at K ranks (cached per module)."""
    key = (method, dtype, n, k, tuple(sorted(kw.items())))
    if key not in _one_card:
        _one_card[key] = port_executor.BatchExecutor(
            "cpu", ranks=k).run_sharded(method, dtype, n, 3,
                                        chunk_bytes=CHUNK_BYTES, **kw)
    return _one_card[key]


def _card_chunks(n, dtype, k, cards):
    """The chunks each card must fold: its ranks' shards, chunked by the
    plan of the longest shard."""
    base = -(-n // k)
    elems = plan_chunks(base, dtype, CHUNK_BYTES).chunk_elems
    chunks = [-(-(min(n, (r + 1) * base) - r * base) // elems)
              for r in range(k)]
    return [sum(chunks[r] for r in b) for b in device.rank_blocks(k, cards)]


@pytest.mark.parametrize("cards", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("method,dtype", PAIRS)
@pytest.mark.parametrize("n", NS)
def test_route_gives_the_one_card_bits(n, method, dtype, k, cards,
                                       both_native):
    ex = port_executor.BatchExecutor("cpu", ranks=k, cards=[CPU] * cards)
    got = ex.run_sharded(method, dtype, n, 3, chunk_bytes=CHUNK_BYTES)
    want = _one(method, dtype, n, k)
    assert got["ok"] is True
    assert {key: got[key] for key in SAME} == \
        {key: want[key] for key in SAME}
    used = min(k, cards)
    assert got["cards"] == used and want["cards"] == 1
    assert got["card_chunks"] == _card_chunks(n, dtype, k, cards)
    assert got["partials_on"] == ["cpu"] * k
    assert got["gather_route"] == ["local"] * used
    assert len(ex.last_shard["fold_cards"]) == used
    assert ex.launches == {f"serve-shard/{method.lower()}": 1}
    if used == 1:
        assert got["note"] == f"the {k} ranks are rows of one tensor on cpu"
    else:
        sizes = sorted({len(b) for b in device.rank_blocks(k, cards)})
        assert got["note"] == (
            f"{k} ranks on {used} cards "
            f"({'-'.join(map(str, sizes))} a card), each card folding its "
            f"ranks' shards; the {k} partials gathered onto cpu for the "
            f"combine")


# ------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def jax_ex():
    return jax_executor.BatchExecutor()


_jax_runs: dict = {}


def _jax(jax_ex, method, dtype, n, k, **kw):
    key = (method, dtype, n, k, tuple(sorted(kw.items())))
    if key not in _jax_runs:
        _jax_runs[key] = jax_ex.run_sharded(
            method, dtype, n, 3, chunk_bytes=CHUNK_BYTES,
            devices=jax.local_devices()[:k], **kw)
    return _jax_runs[key]


@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("method,dtype", [
    ("SUM", "int32"), ("MIN", "int32"), ("MAX", "int32"),
    ("SUM", "float32"), ("SUM", "bfloat16")])
@pytest.mark.parametrize("n", NS)
def test_route_is_jax_run_sharded(jax_ex, n, method, dtype, k, cards,
                                  both_native):
    got = port_executor.BatchExecutor(
        "cpu", ranks=k, cards=[CPU] * cards).run_sharded(
            method, dtype, n, 3, chunk_bytes=CHUNK_BYTES)
    want = _jax(jax_ex, method, dtype, n, k)
    assert got["ok"] is want["ok"] is True
    assert got["host"] == want["host"]
    assert {key: got[key] for key in SELECTION} == \
        {key: want[key] for key in SELECTION}
    if dtype == "int32":
        assert got["result"] == want["result"]
    else:
        tol = tolerance(method, dtype, n)
        assert abs(got["result"] - want["result"]) <= tol


@pytest.mark.parametrize("cards", [2, 3, 4])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_combine_is_jax_selection_and_one_card_bits(
        jax_ex, bits, cards, both_native):
    n = 1 << 16
    got = port_executor.BatchExecutor(
        "cpu", ranks=8, cards=[CPU] * cards).run_sharded(
            "SUM", "float32", n, 3, chunk_bytes=CHUNK_BYTES,
            quantized=True, quant_bits=bits)
    want = _jax(jax_ex, "SUM", "float32", n, 8, quantized=True,
                quant_bits=bits)
    one = _one("SUM", "float32", n, 8, quantized=True, quant_bits=bits)
    assert got["ok"] is want["ok"] is True
    assert got["quantized"] is want["quantized"] is True
    assert {key: got[key] for key in SELECTION} == \
        {key: want[key] for key in SELECTION}
    assert got["algorithm"].startswith(f"q{bits}_")
    assert {key: got[key] for key in SAME} == {key: one[key] for key in SAME}


# ------------------------------------------------------ the engine, faults

def test_engine_sends_an_oversized_request_over_the_cards(tmp_path,
                                                          both_native):
    led = tmp_path / "ledger.jsonl"
    ledger.arm(str(led))
    try:
        ex = port_executor.BatchExecutor("cpu", ranks=8, cards=[CPU] * 4)
        assert ex.capabilities()["cards"] == 4
        eng = port_engine.ServeEngine(executor=ex, coalesce_window_s=0.0,
                                      shard_threshold_bytes=1 << 20,
                                      platform="cpu").start()
        n = 1 << 19                  # 2 MiB of int32: over the 1 MiB line
        r = eng.submit(port_request.ReduceRequest(
            method="SUM", dtype="int", n=n, seed=11)).result(timeout=120)
        eng.stop()
    finally:
        ledger.disarm()
    want = port_executor.BatchExecutor("cpu", ranks=8).run_sharded(
        "SUM", "int32", n, 11)
    assert r.status == "ok", (r.status, r.error)
    assert r.result == want["result"]
    assert r.cards == 4 and r.to_dict()["cards"] == 4
    assert eng.stats["sharded"] == 1
    events = [json.loads(line) for line in led.read_text().splitlines()]
    shard = next(e for e in events if e["ev"] == "serve.shard")
    verify = next(e for e in events if e["ev"] == "serve.verify")
    assert shard["cards"] == verify["cards"] == 4
    assert verify["devices"] == 8


def test_unsharded_response_keeps_the_jax_wire():
    r = port_request.ReduceResponse("r1", "ok", "SUM", "int32", 4, 1.0)
    assert "cards" not in r.to_dict()


def test_a_failing_card_fails_the_request(monkeypatch, both_native):
    """Card 1 fails as it starts to fold (as an out-of-memory card would):
    the request fails with its error, and nothing is run again on the
    card that worked."""
    ex = port_executor.BatchExecutor(
        "cpu", ranks=4, cards=[CPU, torch.device("meta")])
    on_card = ex._on_card

    def failing(card=None):
        if card is not None and card.type == "meta":
            raise RuntimeError("card 1: out of memory")
        return on_card(card)

    monkeypatch.setattr(ex, "_on_card", failing)
    with pytest.raises(RuntimeError, match="card 1: out of memory"):
        ex.run_sharded("SUM", "int32", 1 << 16, 1, chunk_bytes=CHUNK_BYTES)
    assert ex.launches == {"serve-shard/sum": 1}
    assert ex.last_shard is None

    eng = port_engine.ServeEngine(executor=ex, coalesce_window_s=0.0,
                                  shard_threshold_bytes=1 << 10,
                                  platform="cpu").start()
    try:
        r = eng.submit(port_request.ReduceRequest(
            method="SUM", dtype="int", n=1 << 16, seed=1)).result(timeout=60)
    finally:
        eng.stop()
    assert r.status == "error" and "card 1: out of memory" in r.error
    assert r.cards is None
    assert ex.launches == {"serve-shard/sum": 2}
