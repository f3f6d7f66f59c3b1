"""The rank axis across processes: one process a card, NCCL between them.

On the CPU (no card here), with the card's calls mocked where a test
needs them:

- the backend: `initialize_distributed` asks for NCCL on the card, with
  the process's card as `device_id` and the rendezvous store the card
  claim used, and for gloo on the CPU; never gloo on the card;
- the device: process I resolves `cuda:I`, or `cuda:LOCAL_RANK`, which
  the join sets; more processes on the host than cards, a local rank past the
  cards, and two processes on one card are refused with their reasons;
- `_Hop` issues one `batch_isend_irecv` a hop, its sends and receives in
  the permutation's pair order at both ends, every row as its bytes;
- `_all_gather_rows` keeps its input's device;
- the port's collective CLI with P = 2 and 4 processes over gloo
  (bench/multicard.launch) against the JAX collective CLI at --devices=4
  on virtual CPU devices: the reduce.c grid (periter and chained), the
  rooted rows, dd SUM, key MIN/MAX and 8-bit quantized SUM give the JAX
  verdicts and algorithm labels, their oracles the same values, and the
  one-process port's bits wherever `bits_required` asks for them;
  bfloat16 SUM across two processes gives the one-process bits.

Every subprocess has a timeout, and every group is killed if it hangs.
"""

import datetime
import json
import os
import re
import signal
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_reductions import config as jax_config
from tpu_reductions.bench import collective_driver as jax_driver
from tpu_reductions.collectives import \
    host_collective_oracle as jax_oracle
from tpu_reductions_torch import device as port_device
from tpu_reductions_torch.bench import collective_driver as port_driver
from tpu_reductions_torch.bench import multicard
from tpu_reductions_torch.collectives import core as port_core
from tpu_reductions_torch.collectives import rings as port_rings
from tpu_reductions_torch.collectives import \
    host_collective_oracle as port_oracle
from tpu_reductions_torch.config import parse_collective
from tpu_reductions_torch.parallel import mesh as port_mesh

N = 4096
REPO = Path(__file__).resolve().parents[1]

# two processes of an int32 SUM whose every sum overflows int32, the
# script shared with tests/test_torch_cuda.py's twin of this test (NCCL)
OVERFLOW = (REPO / "tests" / "multicard_overflow.py").read_text()


@pytest.fixture
def cards(monkeypatch):
    """A host of `n` mocked cards: returns the list of set_device calls."""
    calls = []

    def install(n: int):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "set_device", calls.append)
        monkeypatch.setattr(
            torch.cuda, "get_device_properties",
            lambda d: types.SimpleNamespace(uuid=f"GPU-{d.index}",
                                            name="mocked card"))
        monkeypatch.delenv("LOCAL_RANK", raising=False)
        return calls
    return install


# --------------------------------------------------------------- backend


def _caught(monkeypatch) -> list:
    seen = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: seen.append((a, k)))
    return seen


def test_cpu_joins_over_gloo(monkeypatch):
    seen = _caught(monkeypatch)
    assert port_mesh.initialize_distributed(
        "127.0.0.1:1234", num_processes=2, process_id=1, platform="cpu")
    (args, kw), = seen
    assert args == ("gloo",)
    assert kw["init_method"] == "tcp://127.0.0.1:1234"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["timeout"] == datetime.timedelta(
        seconds=port_mesh.DIST_TIMEOUT_S)


def test_card_joins_over_nccl_bound_to_its_card(monkeypatch, cards):
    set_to = cards(4)
    seen = _caught(monkeypatch)
    store = _store()
    # process 0 published its card first
    store.set("tpu_reductions_torch/card/0",
              f"{port_mesh.socket.gethostname()}/GPU-0")
    urls = []

    def rendezvous(url, rank, world_size, timeout):
        urls.append((url, rank, world_size, timeout))
        yield store, rank, world_size
    monkeypatch.setattr(dist, "rendezvous", rendezvous)
    assert port_mesh.initialize_distributed(
        "127.0.0.1:1234", num_processes=2, process_id=1)
    (args, kw), = seen
    assert args == ("nccl",)
    assert kw["store"] is store
    assert kw["device_id"] == torch.device("cuda", 1)
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["timeout"] == datetime.timedelta(
        seconds=port_mesh.DIST_TIMEOUT_S)
    assert urls[0][:3] == ("tcp://127.0.0.1:1234", 1, 2)
    assert set_to == [torch.device("cuda", 1)]
    assert store.get("tpu_reductions_torch/card/1").decode().endswith(
        "/GPU-1")


def test_card_never_falls_back_to_gloo(monkeypatch, cards):
    """No card: the join raises before any process group, gloo or NCCL."""
    cards(0)
    seen = _caught(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.initialize_distributed("127.0.0.1:1", num_processes=2,
                                         process_id=0)
    assert seen == []


def test_one_process_joins_nothing(monkeypatch):
    seen = _caught(monkeypatch)
    for platform in ("gpu", "cpu"):
        assert port_mesh.initialize_distributed(
            num_processes=1, platform=platform) is False
    assert seen == []


def test_int32_sum_wraps_across_processes_as_the_oracle():
    port = multicard.free_port()
    group = multicard.run_group(
        [[sys.executable, "-c", OVERFLOW, "cpu", str(port), str(i)]
         for i in range(2)], 120)
    for rc, (out, err) in zip(group["rcs"], group["outs"]):
        assert rc == 0, err
        assert out.startswith("wrapped ")
    assert group["survivors"] == []


def test_a_group_ends_soon_after_a_peer_fails():
    """run_group: a failed process's peer is killed with its process
    group after the grace, not at the deadline; both outputs are kept
    and nothing survives."""
    group = multicard.run_group(
        [[sys.executable, "-c", "import sys; print('out'); "
          "print('err', file=sys.stderr); sys.exit(3)"],
         [sys.executable, "-c", "import time; time.sleep(120)"]],
        timeout_s=100, peer_grace_s=1.0)
    assert group["rcs"] == [3, -signal.SIGKILL]
    assert group["outs"][0] == ("out\n", "err\n")
    assert group["survivors"] == []


def test_a_group_writes_each_log_and_meets_its_deadline(tmp_path):
    logs = [tmp_path / "a.log", tmp_path / "b.log"]
    group = multicard.run_group(
        [[sys.executable, "-c", "print('a')"],
         [sys.executable, "-c", "import time; print('b', flush=True); "
          "time.sleep(120)"]], timeout_s=3.0, logs=logs)
    assert group["rcs"] == [0, -signal.SIGKILL]
    assert [log.read_text() for log in logs] == ["a\n", "b\n"]
    assert group["survivors"] == []


# ---------------------------------------------------------------- device


@pytest.mark.parametrize("pid", [0, 1, 3])
def test_process_i_resolves_cuda_i(cards, pid):
    """resolve names the card (a query); own_card, which the join calls
    once the watchdog is armed, also sets it."""
    set_to = cards(4)
    dev = port_device.resolve("gpu", process_id=pid, num_processes=4)
    assert dev == torch.device("cuda", pid)
    assert set_to == []
    assert port_device.own_card(pid, 4) == dev
    assert set_to == [dev]


def test_local_rank_names_the_card(cards, monkeypatch):
    set_to = cards(2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    # a launcher that gave process 0 the second card
    assert port_device.resolve("gpu", process_id=0, num_processes=2) \
        == torch.device("cuda", 1)
    assert port_device.own_card(0, 2) == torch.device("cuda", 1)
    assert set_to == [torch.device("cuda", 1)]


def test_one_process_keeps_the_current_card(cards):
    set_to = cards(4)
    assert port_device.resolve("gpu") == torch.device("cuda")
    assert port_device.resolve("gpu", process_id=0, num_processes=1) \
        == torch.device("cuda")
    assert set_to == []


def test_more_processes_than_cards_is_refused(cards):
    set_to = cards(2)
    with pytest.raises(RuntimeError,
                       match=r"3 processes on this host but 2 card"):
        port_device.resolve("gpu", process_id=0, num_processes=3)
    assert set_to == []


def test_a_local_rank_past_the_cards_is_refused(cards, monkeypatch):
    cards(2)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="local rank 2 names no card"):
        port_device.resolve("gpu", process_id=0, num_processes=2)


def _store():
    """An in-process store whose waits end in seconds, not minutes."""
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=10))
    return store


def test_two_processes_on_one_card_are_refused(cards):
    cards(4)
    store = _store()
    host = port_mesh.socket.gethostname()
    store.set("tpu_reductions_torch/card/0", f"{host}/GPU-0")
    store.set("tpu_reductions_torch/card/read/0", "1")
    with pytest.raises(RuntimeError, match="processes 0 and 1 both drive "
                                           "card .*duplicate GPU"):
        port_mesh._claim_card(store, torch.device("cuda", 0), 1, 2)


def test_distinct_cards_pass_the_claim(cards):
    cards(4)
    store = _store()
    host = port_mesh.socket.gethostname()
    for p in range(2):
        store.set(f"tpu_reductions_torch/card/{p}", f"{host}/GPU-{p}")
    port_mesh._claim_card(store, torch.device("cuda", 2), 2, 3)
    # process 0, the store's host, waits until every process has read
    store.set("tpu_reductions_torch/card/read/1", "1")
    store.set("tpu_reductions_torch/card/0", f"{host}/GPU-0")
    port_mesh._claim_card(store, torch.device("cuda", 0), 0, 3)


def test_the_mesh_default_is_one_rank_a_process():
    """Without local_ranks a process provides one rank: its own device
    (not torch.cuda.device_count(), which would give four processes on a
    four-card host four ranks each)."""
    m = port_mesh.build_mesh(platform="cpu")
    assert (m.k, m.k_local) == (1, 1)
    assert port_mesh.device_inventory("cpu")["num_devices"] == 1


# ------------------------------------------------------------------ hops


def _mesh(process: int, k: int = 4, nproc: int = 2, device="cpu"):
    per = k // nproc
    return port_mesh.RankMesh(
        k=k, axis_names=("ranks",), mesh_shape=(k,),
        devices=tuple(port_mesh.Place(p, i) for p in range(nproc)
                      for i in range(per)),
        process=process, num_processes=nproc, device=torch.device(device))


def _fake_p2p(monkeypatch):
    """P2POp as a record: the real one wants a process group."""
    monkeypatch.setattr(dist, "P2POp", lambda op, tensor, peer, group=None,
                        tag=0: types.SimpleNamespace(op=op, tensor=tensor,
                                                     peer=peer, tag=tag))


def test_a_hop_is_one_batch_in_pair_order(monkeypatch):
    _fake_p2p(monkeypatch)
    calls = []
    monkeypatch.setattr(dist, "batch_isend_irecv",
                        lambda ops: calls.append(ops) or [])
    perm = port_rings.ring_perm(4)
    lists = {}
    for process in (0, 1):
        mesh = _mesh(process)
        x = torch.arange(8, dtype=torch.int16).reshape(2, 4) + 100 * process
        calls.clear()
        out = port_rings.ppermute(x, perm, mesh)
        assert len(calls) == 1                      # one batch a hop
        ops = calls[0]
        lists[process] = [(op.op is dist.isend, op.peer) for op in ops]
        for op in ops:
            assert op.tensor.dtype == torch.uint8   # a row's bytes
            assert op.tensor.numel() == 4 * 2
        # the local hop: rank 1 <- rank 0, rank 3 <- rank 2
        assert torch.equal(out[1], x[0])
    # pairs (1, 2) and (3, 0) cross: process 0 sends rank 1's row first,
    # then receives rank 0's; process 1 receives first, then sends, the
    # same pairs in the same order
    assert lists[0] == [(True, 1), (False, 1)]
    assert lists[1] == [(False, 0), (True, 0)]


def test_a_received_row_lands_in_the_output(monkeypatch):
    _fake_p2p(monkeypatch)

    def fake(ops):
        for op in ops:
            if op.op is dist.irecv:
                op.tensor.copy_(torch.full_like(op.tensor, 7))
        return []
    monkeypatch.setattr(dist, "batch_isend_irecv", fake)
    out = port_rings.ppermute(torch.zeros(2, 3, dtype=torch.int32),
                              port_rings.ring_perm(4), _mesh(0))
    assert out[0].view(torch.uint8).tolist() == [7] * 12


def test_a_hop_within_one_process_sends_nothing(monkeypatch):
    monkeypatch.setattr(dist, "batch_isend_irecv",
                        lambda ops: pytest.fail("no cross-process row"))
    mesh = _mesh(0, k=4, nproc=1)
    x = torch.arange(4).reshape(4, 1)
    out = port_rings.ppermute(x, port_rings.ring_perm(4), mesh)
    assert out.flatten().tolist() == [3, 0, 1, 2]


def test_all_gather_rows_keeps_its_device(monkeypatch):
    """The gathered rows stay on the input's device (the meta device
    here, which no default allocation lands on)."""
    monkeypatch.setattr(dist, "all_gather", lambda got, mine, group: None)
    mesh = _mesh(0, device="meta")
    out = port_core._all_gather_rows(
        torch.empty(2, 5, dtype=torch.float32, device="meta"), mesh)
    assert out.device.type == "meta" and out.shape == (4, 5)


def test_all_gather_rows_puts_ranks_in_order(monkeypatch):
    """Interleaved ranks: process 0 holds 0 and 2, process 1 holds 1 and
    3; the gathered rows come back in rank order."""
    def gather(got, mine, group):
        got[0].copy_(torch.tensor([[0.0], [2.0]]))
        got[1].copy_(torch.tensor([[1.0], [3.0]]))
    monkeypatch.setattr(dist, "all_gather", gather)
    mesh = port_mesh.RankMesh(
        k=4, axis_names=("ranks",), mesh_shape=(4,),
        devices=(port_mesh.Place(0, 0), port_mesh.Place(1, 0),
                 port_mesh.Place(0, 1), port_mesh.Place(1, 1)),
        process=0, num_processes=2, device=torch.device("cpu"))
    out = port_core._all_gather_rows(torch.tensor([[0.0], [2.0]]), mesh)
    assert out.flatten().tolist() == [0.0, 1.0, 2.0, 3.0]


# ------------------------------------------- P processes against JAX's CLI

GRID = [[f"--method={m}", f"--type={t}", f"--timing={timing}"]
        for t in ("int", "double") for m in ("SUM", "MIN", "MAX")
        for timing in ("periter", "chained")]
ROOTED = [[f"--method={m}", "--type=int", f"--rooted={r}"]
          for m in ("SUM", "MIN") for r in ("scatter", "root")]
PAIRS = [[f"--method={m}", "--type=double", "--f64=dd"]
         for m in ("SUM", "MIN", "MAX")]
QUANT = [["--method=SUM", "--type=float", "--quantized", "--quant-bits=8"]]
ROWS = [r + [f"--n={N}", "--devices=4", "--retries=2", "--chainspan=4"]
        for r in GRID + ROOTED + PAIRS + QUANT]
BF16 = ["--method=SUM", "--type=bfloat16", "--n=65536", "--devices=4",
        "--retries=1"]


# a worker that died joining: the store's or gloo's socket, before any row
_RENDEZVOUS_FAULT = re.compile(
    r"Address already in use|EADDRINUSE|DistNetworkError|DistStoreError|"
    r"Connection (refused|reset)")


def _group(rows, p, out) -> dict:
    res = multicard.launch(rows, p, out, platform="cpu", timeout_s=400)
    res["logs"] = [(out / f"process{i}.log").read_text()[-3000:]
                   for i in range(p)]
    return res


@pytest.fixture(scope="module")
def groups(tmp_path_factory) -> dict:
    """Every row in P = 2 and P = 4 gloo processes (one group each; the
    bfloat16 row in the two-process group), and in one process. A group
    whose rendezvous failed (not the collectives: no worker wrote a row)
    is started once more on a fresh port."""
    runs = {}
    for p in (2, 4):
        rows = ROWS + ([BF16] if p == 2 else [])
        res = _group(rows, p, tmp_path_factory.mktemp(f"p{p}"))
        if (res["rcs"] != [0] * p and not any(res["records"])
                and any(_RENDEZVOUS_FAULT.search(log)
                        for log in res["logs"])):
            res = _group(rows, p, tmp_path_factory.mktemp(f"p{p}"))
        runs[p] = res
    runs["twin"] = list(multicard.twins(ROWS + [BF16], "cpu"))
    return runs


def _jax(argv, tmp_path, monkeypatch) -> list:
    """The JAX CLI's rows (--out) for the same argv on 4 virtual CPU
    devices: the pair route under its TPU_REDUCTIONS_FORCE_DD hook."""
    monkeypatch.delenv("TPU_REDUCTIONS_FORCE_DD", raising=False)
    if "--f64=dd" in argv:
        monkeypatch.setenv("TPU_REDUCTIONS_FORCE_DD", "1")
    out = tmp_path / "jax.json"
    rc = jax_driver.main([a for a in argv if a != "--f64=dd"]
                         + [f"--out={out}"])
    rows = json.loads(out.read_text())["rows"]
    return rc, rows


def _verdicts(rows) -> list:
    """Each row's verification verdict: a chained rep whose slope host
    noise made non-positive is WAIVED after it verified, on either side,
    so WAIVED and PASSED both read as verified."""
    return ["FAILED" if r["status"] == "FAILED" else "verified"
            for r in rows]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("i", range(len(ROWS)),
                         ids=[" ".join(r[:4]) for r in ROWS])
def test_processes_give_the_jax_verdicts_and_one_process_bits(
        groups, p, i, tmp_path, monkeypatch, capsys):
    argv = ROWS[i]
    run = groups[p]
    assert run["rcs"] == [0] * p, run["logs"]
    assert run["survivors"] == []
    recs = [r[i] for r in run["records"]]
    rc, jax_rows = _jax(argv, tmp_path, monkeypatch)
    capsys.readouterr()
    port_rows = recs[0]["results"]
    # the JAX verdict and algorithm, in every process
    assert rc == 0
    for rec in recs:
        assert _verdicts(rec["results"]) == _verdicts(jax_rows) \
            == ["verified"] * 2
        assert [r["algorithm"] for r in rec["results"]] \
            == [r["algorithm"] for r in jax_rows]
    assert [(r["ranks"], r["rooted"]) for r in port_rows] \
        == [(r["ranks"], r["rooted"]) for r in jax_rows]
    # the same payload, so the same oracle values
    cfg = parse_collective(argv + ["--platform=cpu"])
    jcfg = jax_config.parse_collective([a for a in argv if a != "--f64=dd"])
    want = jax_oracle(jax_driver._build_payload(jcfg, 4), 4, jcfg.method)
    got = port_oracle(port_driver._build_payload(cfg, 4), 4, cfg.method)
    assert np.array_equal(np.asarray(want), np.asarray(got))
    # the one-process port: the same verdict, and its bits where required
    tw = groups["twin"][i]
    assert _verdicts(tw["results"]) == _verdicts(port_rows)
    alg = port_rows[0]["algorithm"]
    if multicard.bits_required(cfg.method, cfg.dtype, alg):
        assert multicard.same_bits(tw["views"], recs), argv
    else:    # float SUM through psum: within the registry's tolerance
        ok, diff = multicard.within_tolerance(
            tw["views"], run["kept"][i], cfg.method, cfg.dtype, cfg.n)
        assert ok, (argv, diff)
    # a chained row's chain scalar: process 0's (which holds rank 0) and
    # every process's of a replicated output are the one process's
    if cfg.timing == "chained":
        exact = multicard.bits_required(cfg.method, cfg.dtype, alg)
        assert tw["chain"] is not None
        for j, rec in enumerate(recs):
            if j == 0 or rec["replicated"]:
                assert multicard.chain_agrees(
                    multicard.chain_scalar(rec), tw["chain"], exact,
                    cfg.method, cfg.dtype, cfg.n), (argv, j)
    else:
        assert tw["chain"] is None
        assert all(rec["chain"] is None for rec in recs)
    # only rank 0 reports
    assert "DATATYPE OP NODES GB/sec" in recs[0]["log"]
    assert all(rec["log"] == "" for rec in recs[1:])


def test_bfloat16_sum_across_two_processes_gives_one_process_bits(groups):
    """The accumulation dtype crosses the processes: each adds its rows
    in float32, the all-reduce adds the float32 partials, one rounding
    to bfloat16 at the end, as one process does."""
    run = groups[2]
    recs = [r[len(ROWS)] for r in run["records"]]
    tw = groups["twin"][len(ROWS)]
    for rec in recs:
        assert {r["status"] for r in rec["results"]} == {"PASSED"}
    assert multicard.same_bits(tw["views"], recs)


@pytest.mark.parametrize("rule", [
    ("SUM", "int32", "all_reduce", True),
    ("MIN", "float64", "all_reduce", True),
    ("MAX", "float64", "key_two_phase_all_reduce", True),
    ("SUM", "float64", "dd_ring_rs_ag", True),
    ("SUM", "float32", "q8_ring_rs_ag", True),
    ("SUM", "float64", "all_reduce", False),
    ("SUM", "float32", "reduce_scatter", False),
])
def test_which_rows_must_keep_their_bits(rule):
    *row, want = rule
    assert multicard.bits_required(*row) is want


def test_same_bits_sees_one_changed_element():
    """The digest comparison: a replicated view hashed whole, a scattered
    one by the ranks each process holds; one changed element, or a slice
    taken from the wrong ranks, is a difference."""
    full = [np.arange(16, dtype=np.int32)]
    rep = multicard._sha(full[0])
    recs = [{"sha": [rep], "replicated": True, "owned": [0, 1], "k": 4},
            {"sha": [rep], "replicated": True, "owned": [2, 3], "k": 4}]
    assert multicard.same_bits(full, recs)
    changed = full[0].copy()
    changed[5] += 1
    assert not multicard.same_bits([changed], recs)
    mine = multicard._sha(full[0][8:])
    scattered = {"sha": [mine], "replicated": False, "owned": [2, 3],
                 "k": 4}
    assert multicard.same_bits(full, [scattered])
    assert not multicard.same_bits(full, [dict(scattered, owned=[0, 1])])


# ------------------------------------------------------ the chain's check


class _Chain:
    """A chain whose captured graph and eager loop give set scalars."""

    def __init__(self, graph, eager):
        self.graph, self.loop = graph, eager

    def __call__(self, x, k):
        return self.graph

    def eager(self, x, k):
        return self.loop


_ON_CARD = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"))


@pytest.mark.parametrize("graph, eager, exact, agrees", [
    (torch.tensor(7, dtype=torch.int32), torch.tensor(7, dtype=torch.int32),
     True, True),
    (torch.tensor(7, dtype=torch.int32), torch.tensor(8, dtype=torch.int32),
     True, False),
    # a graph that left the collective out: rank 0's own element only
    (torch.tensor(1.5, dtype=torch.float64),
     torch.tensor(6.0, dtype=torch.float64), False, False),
    (torch.tensor(6.0 + 1e-15, dtype=torch.float64),
     torch.tensor(6.0, dtype=torch.float64), False, True),
    (torch.tensor(6.0 + 1e-15, dtype=torch.float64),
     torch.tensor(6.0, dtype=torch.float64), True, False),
])
def test_a_card_chain_is_held_against_its_eager_loop(graph, eager, exact,
                                                      agrees):
    """On the card the timed graph's scalar is held against the chain run
    one by one: bits where the row must keep them, else the registry's
    tolerance; a difference is logged."""
    cfg = parse_collective(["--method=SUM", "--type=double", "--n=4096",
                            "--platform=cpu"])
    lines = []
    logger = types.SimpleNamespace(log=lines.append)
    got, ok = port_driver._check_chain(_Chain(graph, eager), _ON_CARD, 9,
                                       exact, cfg, logger, keep=True)
    assert ok is agrees
    assert torch.equal(got, graph)
    assert bool(lines) is not agrees
    if lines:
        assert "run one by one" in lines[0] and "FAILED" in lines[0]


def test_a_cpu_chain_is_the_eager_loop(monkeypatch):
    """On the CPU the chain is the eager loop: nothing to hold it against,
    and its scalar is computed only for a caller that keeps it."""
    calls = []
    chain = _Chain(torch.tensor(3), None)
    chain.eager = lambda x, k: pytest.fail("the CPU chain is eager")
    x = torch.zeros(2, 4)
    cfg = parse_collective(["--method=SUM", "--n=4096", "--platform=cpu"])
    log = types.SimpleNamespace(log=calls.append)
    assert port_driver._check_chain(chain, x, 5, True, cfg, log,
                                    keep=False) == (None, True)
    got, ok = port_driver._check_chain(chain, x, 5, True, cfg, log,
                                       keep=True)
    assert ok and int(got) == 3 and calls == []


def test_a_chain_that_disagrees_fails_its_rows(monkeypatch):
    """Every chained row fails when the graph's scalar is not the eager
    loop's, though the collective's output verified."""
    monkeypatch.setattr(port_driver, "_check_chain",
                        lambda *a, **k: (torch.tensor(0), False))
    cfg = parse_collective(["--method=SUM", "--type=int", f"--n={N}",
                            "--devices=4", "--retries=2", "--chainspan=4",
                            "--timing=chained", "--platform=cpu"])
    rows = port_driver.run_collective_benchmark(cfg)
    assert [r.status.name for r in rows] == ["FAILED"] * 2


def test_both_timings_share_one_run():
    """timings= runs periter and then chained over one payload: retries
    rows each, periter's first, verified as the separate runs are, the
    chain's scalar handed to on_result on a chained run only."""
    argv = ["--method=MIN", "--type=int", f"--n={N}", "--devices=4",
            "--retries=2", "--chainspan=4", "--platform=cpu"]
    cfg = parse_collective(argv)
    seen = []
    rows = port_driver.run_collective_benchmark(
        cfg, on_result=lambda out, coll, chain: seen.append(chain),
        timings=("periter", "chained"))
    assert len(rows) == 4
    assert {r.status.name for r in rows} <= {"PASSED", "WAIVED"}
    assert rows[0].status.name == rows[1].status.name == "PASSED"
    chained = port_driver.run_collective_benchmark(
        parse_collective(argv + ["--timing=chained"]),
        on_result=lambda out, coll, chain: seen.append(chain))
    assert torch.equal(seen[0], seen[1])
    assert len(chained) == 2
    port_driver.run_collective_benchmark(
        cfg, on_result=lambda out, coll, chain: seen.append(chain))
    assert seen[2] is None
    with pytest.raises(ValueError, match="without a checkpoint"):
        port_driver.run_collective_benchmark(cfg, checkpoint=object(),
                                             timings=("periter",))


def test_rows_that_differ_only_in_timing_run_as_one():
    rows = [ROWS[0], ROWS[1], ROWS[2], ROWS[12], ROWS[16], ROWS[1]]
    cfgs = [parse_collective(r + ["--platform=cpu"]) for r in rows]
    groups = [(idx, timings)
              for idx, _, timings in multicard._groups(cfgs)]
    assert groups == [([0, 1], ["periter", "chained"]), ([2], ["periter"]),
                      ([3], ["periter"]), ([4], ["periter"]),
                      ([5], ["chained"])]


def test_a_chain_scalar_round_trips_its_record():
    for t in (torch.tensor(-7, dtype=torch.int32),
              torch.tensor(0.1, dtype=torch.float64),
              torch.tensor(1.5, dtype=torch.bfloat16)):
        rec = {"chain": multicard._chain_record(t)}
        back = multicard.chain_scalar(rec)
        assert back.dtype == t.dtype
        assert multicard.chain_agrees(back, t, True, "SUM", "float64", 4)
