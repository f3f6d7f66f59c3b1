"""The port's reshard engine against the JAX package's, on the CPU.

The JAX engine runs on the 8 virtual CPU devices tests/conftest.py
provides; the port's on its rank axis (k ranks as the rows of one CPU
tensor), on the same numpy payloads.

- ShardingSpec's canonical JSON is byte-equal to JAX's, and so are its
  refusals;
- the planner chooses the same programs over the reshard curve's grid:
  steps, algorithms, wire bytes, cost, memory factor, and the naive
  plan's wire;
- every placement is bit-equal to JAX's on the exact wire (the partial
  pair's reduce-scatter included: both add the k addends in rank order)
  and on the quantized wire too (the jitted encode and a plain decode);
  each rank's block is the oracle's, and the measured memory factor is
  within the declared one;
- reshard_curve's rows at ranks 2/4/8 are JAX's but for the times.
"""

import json

import numpy as np
import pytest

from tpu_reductions.bench import reshard_curve as jax_rc
from tpu_reductions import reshard as jax_reshard
from tpu_reductions_torch.bench import reshard_curve as port_rc
from tpu_reductions_torch import reshard as port_reshard

KINDS = ("S0", "S1", "R", "P")


def spec_pair(mod, src_kind, dst_kind, k):
    def one(kind):
        if kind == "R":
            return mod.ShardingSpec.replicated(k, 2)
        if kind == "P":
            return mod.ShardingSpec.replicated(k, 2, partial=True)
        return mod.ShardingSpec.sharded(k, 2, int(kind[1]))
    return one(src_kind), one(dst_kind)


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

SPECS = [
    ((("ranks", 8),), (("ranks",), ()), False),
    ((("ranks", 4),), ((), ("ranks",)), False),
    ((("ranks", 64),), ((), ()), True),
    ((("x", 2), ("y", 3)), (("x",), ("y",), ()), False),
    ((("a", 1),), ((),), False),
]


@pytest.mark.parametrize("mesh, dims, partial", SPECS)
def test_spec_json_is_byte_equal(mesh, dims, partial):
    p = port_reshard.ShardingSpec(mesh, dims, partial)
    j = jax_reshard.ShardingSpec(mesh, dims, partial)
    assert p.to_json() == j.to_json()
    assert port_reshard.ShardingSpec.from_json(j.to_json()) == p
    assert p.to_obj() == j.to_obj()
    assert (p.ndim, p.num_ranks, p.local_fraction()) == \
        (j.ndim, j.num_ranks, j.local_fraction())
    assert _outcome(p.describe) == _outcome(j.describe)


def _outcome(fn):
    """fn()'s value, or its exception's text (a spec that partitions two
    dims has no single-axis description)."""
    try:
        return fn()
    except ValueError as e:
        return str(e)


BAD_SPECS = [
    ((("r", 2), ("r", 2)), ((),), False),
    ((("9x", 2),), ((),), False),
    ((("r", 0),), ((),), False),
    ((("r", 2),), (("q",),), False),
    ((("r", 2),), (("r",), ("r",)), False),
]


@pytest.mark.parametrize("mesh, dims, partial", BAD_SPECS)
def test_spec_refusals_match_jax(mesh, dims, partial):
    msgs = []
    for mod in (port_reshard, jax_reshard):
        with pytest.raises(mod.ShardingSpecError) as e:
            mod.ShardingSpec(mesh, dims, partial)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for text in ("[1]", "not json", '{"mesh": 3}'):
        for mod in (port_reshard, jax_reshard):
            with pytest.raises(mod.ShardingSpecError):
                mod.ShardingSpec.from_json(text)


def test_spec_geometry_matches_jax():
    for k in (2, 4, 8):
        for kind in ("S0", "S1", "R"):
            p, _ = spec_pair(port_reshard, kind, "R", k)
            j, _ = spec_pair(jax_reshard, kind, "R", k)
            assert p.local_shape((16, 64)) == j.local_shape((16, 64))
            assert p.sharded_dim() == j.sharded_dim()


# ---------------------------------------------------------------------------
# the planner and the primitives' declarations
# ---------------------------------------------------------------------------

def test_primitive_declarations_match_jax():
    assert port_reshard.PRIMITIVES.keys() == jax_reshard.PRIMITIVES.keys()
    for name, prim in port_reshard.PRIMITIVES.items():
        ref = jax_reshard.PRIMITIVES[name]
        assert (prim.name, prim.label, prim.mem_note) == \
            (ref.name, ref.label, ref.mem_note)
        for qb in (None, 4, 8, 16):
            assert port_reshard.step_label(name, qb) == \
                jax_reshard.step_label(name, qb)
            for k in (2, 8, 64):
                for in_f, out_f in ((1.0, 1 / k), (1 / k, 1.0),
                                    (1 / k, 1 / k)):
                    args = (name, k, in_f, out_f, qb, 4)
                    assert port_reshard.declared_buffers(*args) == \
                        jax_reshard.declared_buffers(*args)
                    assert port_reshard.declared_mem_factor(*args) == \
                        jax_reshard.declared_mem_factor(*args)
    for bits in (4, 8, 16):
        for itemsize in (2, 4, 8):
            assert port_reshard.quant_compression(bits, itemsize) == \
                jax_reshard.quant_compression(bits, itemsize)
    for args in ((0, 8, 2.0), (2, 8, 3.5), (1, None, 1.0), (3, 4, 0.5)):
        assert port_reshard.reshard_error_bound(*args) == \
            jax_reshard.reshard_error_bound(*args)


PLAN_GRID = [(src, dst, k, qb) for src in KINDS for dst in ("S0", "S1", "R")
             for k in (2, 4, 8, 16, 32, 64) for qb in (None, 4, 8, 16)]


@pytest.mark.parametrize("src, dst, k, qb", PLAN_GRID,
                         ids=[f"{s}-{d}-k{k}-{q or 'exact'}"
                              for s, d, k, q in PLAN_GRID])
def test_plans_match_jax(src, dst, k, qb):
    """The curve's geometry (256 x 4096) and a small one: the same
    program, algorithms, wire bytes, cost and memory factor, the same
    naive plan, and the same refusal under a memory bound."""
    for shape in ((256, 4096), (64, 64 * k)):
        ps, pd = spec_pair(port_reshard, src, dst, k)
        js, jd = spec_pair(jax_reshard, src, dst, k)
        got = port_reshard.plan_reshard(ps, pd, shape, 4, quant_bits=qb)
        ref = jax_reshard.plan_reshard(js, jd, shape, 4, quant_bits=qb)
        assert json.dumps(got.to_obj()) == json.dumps(ref.to_obj())
        assert got.quant_steps == ref.quant_steps
        pn = port_reshard.naive_plan(ps, pd, shape, 4, quant_bits=qb)
        jn = jax_reshard.naive_plan(js, jd, shape, 4, quant_bits=qb)
        assert (pn is None) == (jn is None)
        if pn is not None:
            assert json.dumps(pn.to_obj()) == json.dumps(jn.to_obj())
            assert got.wire_bytes < pn.wire_bytes
        tight = got.mem_factor * 0.5
        msgs = []
        for mod, s, d in ((port_reshard, ps, pd), (jax_reshard, js, jd)):
            try:
                mod.plan_reshard(s, d, shape, 4, mem_bound=tight,
                                 quant_bits=qb)
                msgs.append(None)
            except mod.ReshardPlanError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1]


def test_planner_refusals_match_jax():
    for mod in (port_reshard, jax_reshard):
        s = mod.ShardingSpec.sharded(4, 2, 0)
        with pytest.raises(mod.ReshardPlanError, match="partial TARGET"):
            mod.plan_reshard(s, mod.ShardingSpec.replicated(
                4, 2, partial=True), (8, 8))
        with pytest.raises(mod.ReshardPlanError, match="meshes differ"):
            mod.plan_reshard(s, mod.ShardingSpec.sharded(2, 2, 1), (8, 8))


# ---------------------------------------------------------------------------
# execution against JAX and the oracle
# ---------------------------------------------------------------------------

EXEC_GRID = [(src, dst, k, qb) for k in (2, 4, 8) for src in KINDS
             for dst in ("S0", "S1", "R") for qb in (None, 8)]


@pytest.mark.parametrize("src, dst, k, qb", EXEC_GRID,
                         ids=[f"{s}-{d}-k{k}-{q or 'exact'}"
                              for s, d, k, q in EXEC_GRID])
def test_placements_are_the_jax_bits(src, dst, k, qb):
    shape = (64, 8 * 256)
    ps, pd = spec_pair(port_reshard, src, dst, k)
    js, jd = spec_pair(jax_reshard, src, dst, k)
    rng = np.random.default_rng([k, KINDS.index(src), qb or 0])
    carried = rng.standard_normal(((k,) if ps.partial else ())
                                  + shape).astype(np.float32)
    plan = port_reshard.plan_reshard(ps, pd, shape, 4, quant_bits=qb)
    res = port_reshard.execute_plan(plan, carried,
                                    port_reshard.make_mesh(k, "cpu"))
    ref = jax_reshard.execute_plan(
        jax_reshard.plan_reshard(js, jd, shape, 4, quant_bits=qb),
        carried, jax_reshard.make_mesh(k))
    assert len(res["shards"]) == k
    for g, r in zip(res["shards"], ref["shards"]):
        assert g.shape == r.shape and np.array_equal(g, r)
    m_abs = float(np.abs(carried).max())
    # a quantized crossing rounds against the block max of what crosses:
    # after a reduce-scatter, the sum of the addends
    crossing = float(np.abs(port_reshard.logical_global(carried, ps)).max())
    atol = port_reshard.reshard_error_bound(plan.quant_steps, qb, crossing)
    if ps.partial:
        atol += k * m_abs * 2.0 ** -22
    verdict = port_reshard.verify_placement(carried, ps, pd, res["shards"],
                                            atol=atol)
    assert verdict["ok"], verdict
    assert res["measured_mem_factor"] <= plan.mem_factor + 1e-9
    assert res["measured_mem_factor"] == pytest.approx(
        ref["measured_mem_factor"])
    assert [(s["primitive"], s["algorithm"], s["buffer_bytes"],
             s["mem_factor"]) for s in res["steps"]] == \
        [(s["primitive"], s["algorithm"], s["buffer_bytes"],
          s["mem_factor"]) for s in ref["steps"]]


def test_place_spec_holds_real_replicas():
    k = 4
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    mesh = port_reshard.make_mesh(k, "cpu")
    rep = port_reshard.place_spec(x, port_reshard.ShardingSpec.replicated(
        k, 2), mesh)
    assert rep.shape == (k, 8, 16)
    assert rep.stride(0) == 8 * 16             # k copies, not a view
    col = port_reshard.place_spec(x, port_reshard.ShardingSpec.sharded(
        k, 2, 1), mesh)
    shards = port_reshard.collect_shards(col, mesh)
    for r in range(k):
        assert np.array_equal(shards[r], x[:, 4 * r:4 * (r + 1)])
    with pytest.raises(port_reshard.ShardingSpecError, match="partial"):
        port_reshard.place_spec(x, port_reshard.ShardingSpec.replicated(
            k, 2, partial=True), mesh)


def test_oracle_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    stack = rng.standard_normal((4, 8, 12)).astype(np.float32)
    for mod in (port_reshard, jax_reshard):
        s0 = mod.ShardingSpec.sharded(4, 2, 0)
        part = mod.ShardingSpec.replicated(4, 2, partial=True)
        assert np.array_equal(mod.local_block(x, s0, 2), x[4:6])
        assert np.array_equal(mod.reshard_reference(x, mod.ShardingSpec
                                                    .replicated(4, 2),
                                                    s0, 1), x[2:4])
    assert np.array_equal(port_reshard.logical_global(
        stack, port_reshard.ShardingSpec.replicated(4, 2, partial=True)),
        jax_reshard.logical_global(stack, jax_reshard.ShardingSpec
                                   .replicated(4, 2, partial=True)))
    s0 = port_reshard.ShardingSpec.sharded(4, 2, 0)
    shards = [x[2 * r:2 * r + 2] for r in range(4)]
    assert port_reshard.verify_placement(x, s0, s0, shards)["ok"]
    shards[1] = shards[1] + 1
    v = port_reshard.verify_placement(x, s0, s0, shards)
    assert not v["ok"] and v["max_err"] == pytest.approx(1.0, rel=1e-6)
    with pytest.raises(port_reshard.ShardingSpecError):
        port_reshard.verify_placement(x, s0, s0, shards[:3])


# ---------------------------------------------------------------------------
# the reshard curve
# ---------------------------------------------------------------------------

# what a run measures (times; the card's allocator peak, None here)
TIMED = ("gbps", "wall_s", "device_mem_factor")


def _untimed(row: dict) -> dict:
    row = {key: v for key, v in row.items() if key not in TIMED}
    row["steps"] = [{key: v for key, v in s.items() if key not in TIMED}
                    for s in row["steps"]]
    return row


@pytest.mark.parametrize("k", [2, 4, 8])
def test_reshard_curve_rows_are_the_jax_rows(k):
    n, rows = 1 << 14, 64
    assert port_rc.curve_cells((k,), 8) == jax_rc.curve_cells((k,), 8)
    for pair, wire, kk in port_rc.curve_cells((k,), 8):
        got = port_rc.measure_cell(pair, wire, kk, n, rows, 0,
                                   platform="cpu")
        ref = jax_rc.measure_cell(pair, wire, kk, n, rows, 0)
        assert json.dumps(_untimed(got), sort_keys=True) == json.dumps(
            _untimed(ref), sort_keys=True), (pair, wire)
        assert got["status"] == "PASSED"
        assert got["measured_mem_factor"] <= got["mem_factor"]
        if pair in ("row_to_col", "col_to_row"):
            assert got["plan_wire_bytes"] < got["naive_wire_bytes"]


def test_reshard_curve_resumes_and_folds(tmp_path):
    out = tmp_path / "rc.json"
    rows = port_rc.run_curve(n=1 << 12, rows=16, seed=0, ranks=(2,),
                             out=str(out), platform="cpu")
    assert len(rows) == 7 and all(r["status"] == "PASSED" for r in rows)
    data = json.loads(out.read_text())
    assert data["complete"] is True and data["dim0"] == 16
    data["complete"] = False
    data["rows"][0]["gbps"] = -1.0
    out.write_text(json.dumps(data))
    again = port_rc.run_curve(n=1 << 12, rows=16, seed=0, ranks=(2,),
                              out=str(out), platform="cpu")
    assert again[0]["gbps"] == -1.0
    md = port_rc.reshard_curve_markdown({"rows": rows})
    assert md.splitlines()[:3] == jax_rc.reshard_curve_markdown(
        {"rows": rows}).splitlines()[:3]
    assert md == jax_rc.reshard_curve_markdown({"rows": rows})
    assert port_rc.reshard_curve_markdown({"rows": []}) == ""


def test_execute_plan_times_the_median_of_warm_calls(monkeypatch):
    """Each step: STEP_WARMUP untimed calls, then `repeats` timed calls on
    the same input, its wall_s their median; no allocator peak on the
    CPU; and the same bits as one call."""
    k, shape = 4, (16, 64)
    src = port_reshard.ShardingSpec.sharded(k, 2, 0)
    dst = port_reshard.ShardingSpec.sharded(k, 2, 1)
    plan = port_reshard.plan_reshard(src, dst, shape, 4)
    carried = np.random.default_rng(5).standard_normal(shape).astype(
        np.float32)
    mesh = port_reshard.make_mesh(k, "cpu")
    from tpu_reductions_torch.reshard import primitives
    from tpu_reductions_torch.utils import timing
    calls = []
    build = primitives.build_step

    def counted(*args, **kwargs):
        fn, aux = build(*args, **kwargs)
        return (lambda x: calls.append(1) or fn(x)), aux
    monkeypatch.setattr(primitives, "build_step", counted)
    # the timed calls' (start, stop) clock readings: 1, 2 and 7 s
    ticks = iter([0.0, 1.0, 10.0, 12.0, 20.0, 27.0])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    res = port_reshard.execute_plan(plan, carried, mesh)
    monkeypatch.undo()
    assert len(plan.steps) == 1
    assert len(calls) == primitives.STEP_WARMUP + primitives.STEP_REPEATS
    assert [s["wall_s"] for s in res["steps"]] == [2.0]
    assert res["wall_s"] == 2.0
    assert res["device_mem_factor"] is None
    assert res["steps"][0]["device_mem_factor"] is None
    once = port_reshard.execute_plan(plan, carried, mesh, repeats=1)
    for g, w in zip(res["shards"], once["shards"]):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError, match="repeats must be >= 1"):
        port_reshard.execute_plan(plan, carried, mesh, repeats=0)


def test_card_rows_add_the_allocator_peak_column():
    """Rows with a card peak add a column and a note to the JAX table;
    rows without one (the CPU) keep the JAX table word for word."""
    rows = port_rc.run_curve(n=1 << 12, rows=16, seed=0, ranks=(2,),
                             platform="cpu")
    card = [dict(r, device_mem_factor=1.25) for r in rows]
    md = port_rc.reshard_curve_markdown({"rows": card})
    plain = port_rc.reshard_curve_markdown({"rows": rows})
    assert md.splitlines()[4] == plain.splitlines()[4] + " card peak |"
    assert all(ln.endswith(" 1.250 |") for ln in md.splitlines()[6:-2])
    assert "the ops' temporaries included" in md.splitlines()[-1]


def test_a_replica_that_differs_is_verified_on_its_own():
    """collect_shards hands back rank 0's block for every bit-identical
    replica, and a copy of any row that differs, which the oracle then
    catches."""
    k = 4
    x = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    mesh = port_reshard.make_mesh(k, "cpu")
    rep = port_reshard.ShardingSpec.replicated(k, 2)
    y = port_reshard.place_spec(x, rep, mesh)
    shards = port_reshard.collect_shards(y, mesh)
    assert all(s is shards[0] for s in shards)
    assert port_reshard.verify_placement(x, rep, rep, shards)["ok"]
    y[2, 3, 4] += 1.0
    shards = port_reshard.collect_shards(y, mesh)
    assert shards[2] is not shards[0] and shards[3] is shards[0]
    v = port_reshard.verify_placement(x, rep, rep, shards)
    assert not v["ok"] and v["max_err"] == pytest.approx(1.0, rel=1e-6)
