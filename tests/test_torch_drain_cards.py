"""The drain's reshard across cards, on the CPU: C entries of the CPU
device stand in for the host's cards (`BatchExecutor("cpu", ranks=k,
cards=["cpu"] * C)`), each card's block a tensor of its own and each hop
a copy into a fresh buffer, one host thread a card (parallel/peer.py).

- placement: a k-rank mesh on min(k, C) cards in rank-ordered blocks,
  one RankMesh a card sharing one peer group (parallel/mesh.peer_meshes);
- against the twin: every program of tests/test_torch_reshard.py's
  EXEC_GRID on C = 2 and 4 cards against `cards=["cpu"]` (the ranks as
  rows of one tensor): the twin's bits for a program without a
  reduce_scatter, within k * max|x| * 2^-22 plus the declared quantized
  bound of them for a partial source, the same step rows and accounted
  memory factor;
- against the JAX package: the k = 8 grid on 4 cards against
  tpu_reductions.reshard.execute_plan on make_mesh(8) over the 8 virtual
  CPU devices;
- the drain: `_reshard_partials` on 4 cards beside the JAX drain's, and a
  full `drain_replica` on a router of LocalReplicas that sheds nothing;
  the reshard curve's programs through bench/drain_cards.drain_rows;
- a fault on one card's thread raises within seconds, the original error,
  with no thread left; a rendezvous nobody joins times out; the peer
  all-reduce keeps its card order under more threads than cores.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_reductions import reshard as jax_reshard
from tpu_reductions.serve import autoscale as jax_autoscale
from tpu_reductions.serve.executor import BatchExecutor as JaxExecutor
from tpu_reductions_torch import device as port_device
from tpu_reductions_torch import reshard as port_reshard
from tpu_reductions_torch.bench import drain_cards
from tpu_reductions_torch.parallel import mesh as port_mesh
from tpu_reductions_torch.parallel import peer
from tpu_reductions_torch.reshard import primitives
from tpu_reductions_torch.serve import autoscale as port_autoscale
from tpu_reductions_torch.serve.executor import BatchExecutor

# tests/test_torch_reshard.py's grid: every (src, dst, k, quant bits)
KINDS = ("S0", "S1", "R", "P")
EXEC_GRID = [(src, dst, k, qb) for k in (2, 4, 8) for src in KINDS
             for dst in ("S0", "S1", "R") for qb in (None, 8)]
SHAPE = (64, 8 * 256)


def spec_pair(mod, src_kind, dst_kind, k):
    def one(kind):
        if kind == "R":
            return mod.ShardingSpec.replicated(k, 2)
        if kind == "P":
            return mod.ShardingSpec.replicated(k, 2, partial=True)
        return mod.ShardingSpec.sharded(k, 2, int(kind[1]))
    return one(src_kind), one(dst_kind)


def _case(src, dst, k, qb):
    """(port specs, plan, carried, bound): the reshard test's draw, and
    the bound a partial source is held to (its f32 sum's k half-ulps and
    the declared quantized crossings)."""
    ps, pd = spec_pair(port_reshard, src, dst, k)
    rng = np.random.default_rng([k, KINDS.index(src), qb or 0])
    carried = rng.standard_normal(((k,) if ps.partial else ())
                                  + SHAPE).astype(np.float32)
    plan = port_reshard.plan_reshard(ps, pd, SHAPE, 4, quant_bits=qb)
    crossing = float(np.abs(port_reshard.logical_global(carried, ps)).max())
    bound = port_reshard.reshard_error_bound(plan.quant_steps, qb, crossing)
    if ps.partial:
        bound += k * float(np.abs(carried).max()) * 2.0 ** -22
    return ps, pd, plan, carried, bound


def _steps(res):
    return [(s["primitive"], s["algorithm"], s["buffer_bytes"],
             s["mem_factor"]) for s in res["steps"]]


def _hold(got, want, partial, bound):
    """The cards' shards against another placement's: its bits, or for a
    partial source within `bound`."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if partial:
            assert float(np.max(np.abs(g.astype(np.float64) - w))) <= bound
        else:
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cards", [1, 2, 3, 4])
@pytest.mark.parametrize("k", range(1, 9))
def test_peer_meshes_place_the_blocks(k, cards):
    meshes = port_mesh.peer_meshes(k, ["cpu"] * cards)
    blocks = port_device.rank_blocks(k, cards)
    assert len(meshes) == min(k, cards) == len(blocks)
    for c, m in enumerate(meshes):
        assert m.k == k and m.process == c
        assert m.num_processes == len(blocks)
        assert m.owned == tuple(blocks[c])
        assert m.index.tolist() == list(blocks[c])
        assert m.spans_processes == (len(blocks) > 1)
    groups = {id(m.group) for m in meshes}
    assert len(groups) == 1
    assert (meshes[0].group is None) == (len(blocks) == 1)


# ---------------------------------------------------------------------------
# against the one-card twin
# ---------------------------------------------------------------------------

TWIN_CASES = [(c,) + g for c in (2, 4) for g in EXEC_GRID]


@pytest.mark.parametrize("cards, src, dst, k, qb", TWIN_CASES,
                         ids=[f"C{c}-{s}-{d}-k{k}-{q or 'exact'}"
                              for c, s, d, k, q in TWIN_CASES])
def test_cards_hold_the_twins_bits(cards, src, dst, k, qb):
    ps, pd, plan, carried, bound = _case(src, dst, k, qb)
    got = BatchExecutor("cpu", ranks=k,
                        cards=["cpu"] * cards).run_reshard(plan, carried)
    twin = BatchExecutor("cpu", ranks=k,
                         cards=["cpu"]).run_reshard(plan, carried)
    used = min(k, cards)
    assert got["cards"] == used and twin["cards"] == 1
    assert got["copy_route"] == {f"{a}-{b}": "local" for a in range(used)
                                 for b in range(a + 1, used)}
    assert twin["copy_route"] == {}
    _hold(got["shards"], twin["shards"], ps.partial, bound)
    assert _steps(got) == _steps(twin)
    assert got["measured_mem_factor"] == twin["measured_mem_factor"]
    assert got["measured_mem_factor"] <= plan.mem_factor + 1e-9
    assert got["device_mem_factor"] is None     # the CPU has no allocator
    assert port_reshard.verify_placement(carried, ps, pd, got["shards"],
                                         atol=bound)["ok"]


# ---------------------------------------------------------------------------
# against the JAX package, k = 8 on 4 cards
# ---------------------------------------------------------------------------

JAX_CASES = [g for g in EXEC_GRID if g[2] == 8]


@pytest.mark.parametrize("src, dst, k, qb", JAX_CASES,
                         ids=[f"C4-{s}-{d}-k{k}-{q or 'exact'}"
                              for s, d, k, q in JAX_CASES])
def test_cards_hold_the_jax_bits(src, dst, k, qb):
    ps, pd, plan, carried, bound = _case(src, dst, k, qb)
    js, jd = spec_pair(jax_reshard, src, dst, k)
    got = BatchExecutor("cpu", ranks=k,
                        cards=["cpu"] * 4).run_reshard(plan, carried)
    ref = jax_reshard.execute_plan(
        jax_reshard.plan_reshard(js, jd, SHAPE, 4, quant_bits=qb),
        carried, jax_reshard.make_mesh(k))
    _hold(got["shards"], ref["shards"], ps.partial, bound)
    assert _steps(got) == _steps(ref)
    assert got["measured_mem_factor"] == pytest.approx(
        ref["measured_mem_factor"])


# ---------------------------------------------------------------------------
# the drain
# ---------------------------------------------------------------------------

def test_the_drains_reshard_across_four_cards_is_the_jax_drains():
    got = port_autoscale._reshard_partials(
        "victim", executor=BatchExecutor("cpu", ranks=8,
                                         cards=["cpu"] * 4),
        mem_bound=2.0, seed=3)
    ref = jax_autoscale._reshard_partials("victim",
                                          executor=JaxExecutor(),
                                          mem_bound=2.0, seed=3)
    assert got["ok"] is True and got["mem_ok"] is True
    assert (got["ranks"], got["cards"]) == (8, 4)
    assert got["program"] == ref["program"]
    assert (got["mem_factor"], got["measured_mem_factor"]) == \
        (ref["mem_factor"], ref["measured_mem_factor"])
    assert got["max_err"] <= got["bound"] == pytest.approx(ref["bound"])


def test_drain_replica_across_four_cards_sheds_nothing():
    got = drain_cards.drain_fleet(
        BatchExecutor("cpu", ranks=8, cards=["cpu"] * 4), platform="cpu")
    twin = drain_cards.drain_fleet(
        BatchExecutor("cpu", ranks=8, cards=["cpu"]), platform="cpu")
    assert drain_cards.check_drain(got, 4, twin) == []
    assert drain_cards.check_drain(twin, 1) == []
    assert got["reshard"]["program"] == ["reduce_scatter"]


def test_drain_rows_hold_every_curve_program():
    """bench/drain_cards.drain_rows, as [multicard] runs it on the cards:
    the reshard curve's 7 (pair, wire) programs at k = 2, 4, 8."""
    rows = list(drain_cards.drain_rows((2, 4, 8), 1 << 16, 64, 0,
                                       ["cpu"] * 4, platform="cpu"))
    assert len(rows) == 21
    assert drain_cards.failures(rows) == []
    for r in rows:
        assert r["cards"] == min(r["ranks"], 4)
        assert r["same_bits"] or "reduce_scatter" in r["program"]
        assert "PASSED" in drain_cards.summary(r)


# ---------------------------------------------------------------------------
# faults and the rendezvous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("card", [0, 1, 3])
def test_a_fault_on_one_card_raises_within_seconds(monkeypatch, card):
    """A card's thread that raises in its second step aborts the peer
    group: run_reshard raises that error, not another card's
    PeerAborted, within seconds, and leaves no thread alive."""
    real = primitives.build_step

    def faulty(step, mesh, global_shape, dtype):
        fn, aux = real(step, mesh, global_shape, dtype)
        if step.primitive != "all_gather" or mesh.process != card:
            return fn, aux

        def boom(x):
            raise RuntimeError(f"card {card} lost its step")
        return boom, aux

    monkeypatch.setattr(primitives, "build_step", faulty)
    ps, pd, plan, carried, _ = _case("P", "R", 8, None)
    assert [s.primitive for s in plan.steps] == ["reduce_scatter",
                                                 "all_gather"]
    before = set(threading.enumerate())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=f"card {card} lost its step"):
        BatchExecutor("cpu", ranks=8,
                      cards=["cpu"] * 4).run_reshard(plan, carried)
    assert time.monotonic() - t0 < 10
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert left == []


def test_a_rendezvous_nobody_joins_times_out():
    group = peer.PeerGroup(2, timeout_s=0.2)
    t0 = time.monotonic()
    with pytest.raises(peer.PeerAborted, match="did not come"):
        group.member(0).barrier()
    assert time.monotonic() - t0 < 5
    with pytest.raises(peer.PeerAborted):
        group.member(1).barrier()


def test_peer_all_reduce_keeps_card_order_under_contention():
    """16 card threads (more than the cores) with a short switch interval,
    200 rounds: every round's all-reduce on every card equals the
    card-order combine of that round's offers, and every all-gather
    lands each card's piece in its slot."""
    size, rounds = 16, 200
    group = peer.PeerGroup(size, timeout_s=60)
    errors, results = [], [[None] * rounds for _ in range(size)]

    def card(c):
        try:
            me = group.member(c)
            for r in range(rounds):
                t = torch.full((4,), float(c * 1000 + r))
                me.all_reduce(t, "SUM")
                got = [torch.empty(2) for _ in range(size)]
                me.all_gather(got, torch.tensor([float(c), float(r)]))
                results[c][r] = (t.clone(), [g.tolist() for g in got])
        except BaseException as e:    # the assertion below reports it
            group.abort()
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=card, args=(c,))
                   for c in range(size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for r in range(rounds):
        want = sum(float(c * 1000 + r) for c in range(size))
        for c in range(size):
            total, pieces = results[c][r]
            assert torch.equal(total, torch.full((4,), want))
            assert pieces == [[float(j), float(r)] for j in range(size)]
