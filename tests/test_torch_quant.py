"""The port's quantized wire and topology rings against the JAX package's,
on the CPU.

The JAX constructors run on the 8 virtual CPU devices tests/conftest.py
provides; the port's on its rank axis (k ranks as the rows of one CPU
tensor), on the same numpy payloads.

The tolerance against the JAX ring: bit-equal. Two things make the JAX
ring's bits what they are, and the port reproduces both:
- XLA's algebraic simplifier compiles the scale max|x| / levels, a
  division by a constant, into max|x| * float32(1 / levels) in every
  jitted collective (an eager `block_encode` divides; the jitted one is
  held here, since it is what runs);
- XLA on the CPU contracts the ring's `tgt + q * s` and the residual's
  `y - q * s` into fused multiply-adds, one rounding each; the port forms
  the exact product and the sum in float64 and rounds once to float32.
The exact psum fallback adds its ranks in XLA's order against the port's
torch order, so it is held to the driver's float32 rtol (1e-6), as the
exact all-reduce is in tests/test_torch_collectives.py. Every ring is
also held within its declared `quant_error_bound` of the float64 oracle.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_reductions.bench import quant_curve as jax_qc
from tpu_reductions.collectives import core as jax_core
from tpu_reductions.collectives import quant as jax_quant
from tpu_reductions.collectives import rings as jax_rings
from tpu_reductions.ops.dd_reduce import host_key_encode as jax_key_encode
from tpu_reductions.ops.dd_reduce import host_split as jax_host_split
from tpu_reductions.parallel import mesh as jax_mesh
from tpu_reductions.utils.rng import host_data as jax_host_data
from tpu_reductions_torch import collectives as port
from tpu_reductions_torch import parallel as port_parallel
from tpu_reductions_torch.bench import quant_curve as port_qc
from tpu_reductions_torch.collectives import quant as port_quant
from tpu_reductions_torch.collectives import rings as port_rings
from tpu_reductions_torch.ops.dd_reduce import host_key_decode
from tpu_reductions_torch.parallel import mesh as port_mesh
from tpu_reductions_torch.utils.logging import (QUANT_CURVE_HEADER,
                                                quant_curve_row)
from tpu_reductions_torch.utils.rng import host_data

AXIS = "ranks"
FALLBACK_RTOL = 1e-6


def meshes(k):
    return (jax_mesh.build_mesh(num_devices=k),
            port_mesh.build_mesh(num_devices=k, platform="cpu",
                                 local_ranks=8))


def jax_planes(fn, planes, mesh):
    out = fn(*[jax_core.shard_payload(p, mesh, AXIS) for p in planes])
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.astype(jnp.float32) if o.dtype == jnp.bfloat16
                       else o) for o in out]


def as_torch(p):
    """numpy -> torch; JAX's bfloat16 arrays, which torch cannot take from
    numpy, through their exact float32 values."""
    if p.dtype == jnp.bfloat16:
        return torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.asarray(p))


def port_planes(coll, planes, mesh):
    out = coll(*[port.shard_payload(as_torch(p), mesh) for p in planes])
    out = out if isinstance(out, tuple) else (out,)
    return [(o.float() if o.dtype == torch.bfloat16 else o).numpy()
            for o in out]


def draw(k, per, seed=0):
    return np.random.default_rng([seed, k]).standard_normal(k * per)


# ---------------------------------------------------------------------------
# the encoding
# ---------------------------------------------------------------------------

JAX_ENCODE = jax.jit(jax_quant.block_encode, static_argnums=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_block_encode_matches_the_jitted_jax_encode(bits, seed):
    x = np.random.default_rng(seed).standard_normal(1 << 14).astype(
        np.float32) * (10.0 ** seed)
    x[:256] = 0.0                        # a zero block: its scale is 1
    x[256:512] = 1e-30                   # a tiny one
    jc, js = JAX_ENCODE(jnp.asarray(x), bits)
    pc, ps = port_quant.block_encode(torch.from_numpy(x), bits)
    assert pc.dtype == {4: torch.uint8, 8: torch.int8, 16: torch.int16}[bits]
    assert np.array_equal(np.asarray(jc), pc.numpy())
    assert np.array_equal(np.asarray(js), ps.numpy())
    assert ps[0] == 1.0
    assert np.array_equal(np.asarray(jax_quant.block_decode(jc, js, bits)),
                          port_quant.block_decode(pc, ps, bits).numpy())
    # row by row on the rank axis: each row encodes on its own
    rows = torch.from_numpy(x).view(4, -1)
    rc, rs = port_quant.block_encode(rows, bits)
    assert torch.equal(rc.reshape(-1), pc) and torch.equal(rs.reshape(-1),
                                                           ps)


def test_pack4_round_trip_and_nibbles():
    q = torch.arange(-7, 8, dtype=torch.int32).repeat(20)[:256]
    packed = port_quant._pack4(q)
    assert packed.dtype == torch.uint8 and packed.numel() == 128
    assert torch.equal(port_quant._unpack4(packed), q)
    ref = np.asarray(jax_quant._pack4(jnp.asarray(q.numpy())))
    assert np.array_equal(packed.numpy(), ref)
    two = q.view(2, -1)                  # per row, as a hop carries it
    assert torch.equal(port_quant._unpack4(port_quant._pack4(two)), two)


def test_error_bound_matches_jax():
    for method in ("SUM", "MIN", "MAX"):
        for dtype in ("float32", "bfloat16", "float64"):
            for bits in (4, 8, 16):
                for k in (1, 2, 8, 64):
                    for ef in (True, False):
                        args = (method, dtype, bits, k, 3.25, ef)
                        assert port_quant.quant_error_bound(*args) == \
                            jax_quant.quant_error_bound(*args)


def test_monotone_and_coarse_keys_match_jax():
    x = np.concatenate([np.random.default_rng(5).standard_normal(4096),
                        [0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40]]
                       ).astype(np.float32)
    key = port_quant.monotone_key32(torch.from_numpy(x))
    assert np.array_equal(key.numpy(), port_quant.np_monotone_key32(x))
    assert np.array_equal(key.numpy(), np.asarray(
        jax_quant.monotone_key32(jnp.asarray(x))))
    # sorted by key, the floats are in order (-0.0 keys just below 0.0)
    assert np.all(np.diff(x[np.argsort(key.numpy(), kind="stable")]) >= 0)
    for bits in (8, 16):
        c = port_quant.coarse_key(key, bits)
        ref = np.asarray(jax_quant.coarse_key(jnp.asarray(key.numpy()),
                                              bits))
        assert c.dtype == {8: torch.int8, 16: torch.int16}[bits]
        assert np.array_equal(c.numpy(), ref)


# ---------------------------------------------------------------------------
# the quantized SUM rings
# ---------------------------------------------------------------------------

SUM_GRID = [(dtype, bits, ef, k)
            for dtype in ("float32", "bfloat16", "float64")
            for bits in (4, 8, 16) for ef in (True, False)
            for k in (2, 4, 8)]


def _sum_case(dtype, k, per, seed=0):
    """(planes, f64 oracle, max|x|) of one quantized SUM case."""
    x64 = draw(k, per, seed)
    if dtype == "float64":
        hi, lo = jax_host_split(x64)
        return (hi, lo), x64.reshape(k, -1).sum(axis=0), \
            float(np.abs(x64).max())
    x = x64.astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, dtype=jnp.bfloat16))
    xf = x.astype(np.float32).astype(np.float64)
    return (x,), xf.reshape(k, -1).sum(axis=0), float(np.abs(xf).max())


@pytest.mark.parametrize("dtype, bits, ef, k", SUM_GRID,
                         ids=[f"{d}-q{b}-{'ef' if e else 'noef'}-k{k}"
                              for d, b, e, k in SUM_GRID])
def test_quant_sum_ring_is_the_jax_rings_bits(dtype, bits, ef, k):
    jm, pm = meshes(k)
    planes, want, m_abs = _sum_case(dtype, k, 2 * k * 256)
    ref = jax_planes(jax_quant.make_quant_sum_all_reduce(
        jm, AXIS, bits=bits, dtype=dtype, error_feedback=ef), planes, jm)
    got = port_planes(port_quant.make_quant_sum_all_reduce(
        pm, bits=bits, dtype=dtype, error_feedback=ef), planes, pm)
    for g, r in zip(got, ref):
        assert g.shape == (k, r.shape[0])
        for row in g:                      # every replica: the JAX bits
            assert np.array_equal(row, r)
    bound = port_quant.quant_error_bound("SUM", dtype, bits, k, m_abs, ef)
    total = got[0].astype(np.float64) + (got[1] if len(got) == 2 else 0.0)
    assert np.abs(total - want).max() <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("k, per", [(8, 2 * 8 * 256 - 8), (3, 1000),
                                    (8, 128)])
def test_fallback_geometry_runs_the_exact_psum(dtype, k, per):
    """Where the per-rank length is no multiple of k * 256 both packages
    run the exact psum: the port's within float32's rtol of JAX's (the
    two psums add in their own orders) and within the declared bound."""
    assert not port_quant.quant_ring_applies(k, per)
    assert port.quant_ring_algorithm(k, per, 8, dtype) == "all_reduce"
    jm, pm = meshes(k)
    planes, want, m_abs = _sum_case(dtype, k, per, seed=3)
    ref = jax_planes(jax_quant.make_quant_sum_all_reduce(
        jm, AXIS, bits=8, dtype=dtype), planes, jm)
    got = port_planes(port_quant.make_quant_sum_all_reduce(
        pm, bits=8, dtype=dtype), planes, pm)
    rtol = 1e-2 if dtype == "bfloat16" else FALLBACK_RTOL
    for g, r in zip(got, ref):
        for row in g:
            np.testing.assert_allclose(row, r, rtol=rtol, atol=rtol)
    bound = port_quant.quant_error_bound("SUM", dtype, 8, k, m_abs)
    total = got[0].astype(np.float64) + (got[1] if len(got) == 2 else 0.0)
    assert np.abs(total - want).max() <= bound


def test_graft_check6_on_the_ports_q8_ring():
    """__graft_entry__.dryrun_multichip's check 6 at k = 8 on the port's
    make_q8_sum_all_reduce (imported from the port's parallel package,
    as the check imports JAX's): within k * (k * max|x| / 127) of the
    exact sum, and the JAX ring's values on the same payload."""
    k = 8
    jm, pm = meshes(k)
    per_q = k * port_parallel.Q8_BLOCK
    xq = np.concatenate([host_data(per_q, "float32", rank=r).numpy()
                         for r in range(k)])
    assert np.array_equal(xq, np.concatenate(
        [np.asarray(jax_host_data(per_q, "float32", rank=r))
         for r in range(k)]))
    q8 = port_parallel.make_q8_sum_all_reduce(pm)
    got = q8(port.shard_payload(xq, pm)).numpy()
    exact = xq.reshape(k, per_q).astype(np.float64).sum(axis=0)
    assert np.abs(got[0] - exact).max() <= k * (k * np.abs(xq).max()
                                                / 127.0)
    ref = np.asarray(jax_quant.make_q8_sum_all_reduce(jm, AXIS)(
        jax_core.shard_payload(xq, jm, AXIS)))
    for row in got:
        assert np.array_equal(row, ref)


# ---------------------------------------------------------------------------
# the quantized key MIN/MAX
# ---------------------------------------------------------------------------

KEY_GRID = [(m, d, b, k) for m in ("MIN", "MAX")
            for d in ("float32", "float64") for b in (8, 16)
            for k in (2, 4, 8)]


@pytest.mark.parametrize("method, dtype, bits, k", KEY_GRID,
                         ids=["-".join(map(str, g)) for g in KEY_GRID])
def test_quant_key_minmax_is_exact_and_the_jax_bits(method, dtype, bits, k):
    jm, pm = meshes(k)
    # ties on purpose: a coarse phase with many candidates
    x64 = np.round(draw(k, 1000, seed=7) * 4) / 4
    blocks = x64.reshape(k, -1)
    want = (np.minimum if method == "MIN" else np.maximum).reduce(blocks,
                                                                  axis=0)
    if dtype == "float64":
        planes = jax_key_encode(x64)
    else:
        planes = (x64.astype(np.float32),)
        want = want.astype(np.float32)
    ref = jax_planes(jax_quant.make_quant_key_minmax_all_reduce(
        method, jm, AXIS, bits=bits, dtype=dtype), planes, jm)
    got = port_planes(port_quant.make_quant_key_minmax_all_reduce(
        method, pm, bits=bits, dtype=dtype), planes, pm)
    for g, r in zip(got, ref):
        for row in g:
            assert np.array_equal(row, r)
    value = (host_key_decode(got[0][0], got[1][0]) if dtype == "float64"
             else got[0][0])
    assert np.array_equal(value, want)


def test_quant_key_refuses_sum():
    _, pm = meshes(2)
    with pytest.raises(ValueError, match="MIN/MAX"):
        port_quant.make_quant_key_minmax_all_reduce("SUM", pm)


# ---------------------------------------------------------------------------
# ring_all_to_all and the topology constructors
# ---------------------------------------------------------------------------

A2A_GRID = [(k, split, concat, wire) for k in (1, 2, 4, 8)
            for split, concat in ((1, 0), (0, 1)) for wire in (None, 8, 4)]


@pytest.mark.parametrize("k, split, concat, wire", A2A_GRID,
                         ids=[f"k{k}-s{s}-c{c}-{w or 'exact'}"
                              for k, s, c, w in A2A_GRID])
def test_ring_all_to_all_matches_jax(k, split, concat, wire):
    """A block sharded on `concat` becomes one sharded on `split`; the
    rank's own piece is stored exactly, the others cross the (optionally
    quantized) wire: every rank's block is JAX's."""
    jm, pm = meshes(k)
    rows, cols = 8 * 16, 8 * 256
    x = np.random.default_rng([k, split]).standard_normal(
        (rows, cols)).astype(np.float32)
    in_shape = (rows // k, cols) if concat == 0 else (rows, cols // k)
    piece = list(in_shape)
    piece[split] //= k

    def jax_tw(p):
        return jax_quant.block_encode(p.reshape(-1), wire)

    def jax_fw(rx):
        return jax_quant.block_decode(rx[0], rx[1], wire).reshape(piece)

    in_spec = P(AXIS, None) if concat == 0 else P(None, AXIS)
    out_spec = P(AXIS, None) if split == 0 else P(None, AXIS)
    fn = jax.jit(jax_rings.shard_map(
        lambda b: jax_rings.ring_all_to_all(
            AXIS, k, b, split_axis=split, concat_axis=concat,
            to_wire=jax_tw if wire else None,
            from_wire=jax_fw if wire else None),
        mesh=jm, in_specs=in_spec, out_specs=out_spec, check_vma=False))
    ref = np.asarray(fn(jax.device_put(
        x, jax.sharding.NamedSharding(jm, in_spec))))
    blocks = np.stack(np.split(x, k, axis=concat))     # (k, *in_shape)
    got = port_rings.ring_all_to_all(
        pm, k, torch.from_numpy(blocks), split_axis=split,
        concat_axis=concat,
        to_wire=(lambda p: port_quant.block_encode(p.reshape(k, -1), wire))
        if wire else None,
        from_wire=(lambda rx: port_quant.block_decode(
            rx[0], rx[1], wire).reshape(k, *piece)) if wire else None)
    want = np.stack(np.split(ref, k, axis=split))
    assert np.array_equal(got.numpy(), want)
    if wire is None:
        assert np.array_equal(np.concatenate(list(got.numpy()),
                                             axis=split), x)


TOPO_GRID = [(t, m, k, per) for t in ("ring", "bidir", "torus2d", "naive")
             for m in ("SUM", "MIN", "MAX")
             for k, per in ((2, 64), (4, 96), (6, 72), (8, 64), (5, 30),
                            (8, 20))]


@pytest.mark.parametrize("topology, method, k, per", TOPO_GRID,
                         ids=["-".join(map(str, g)) for g in TOPO_GRID])
def test_topology_all_reduce_matches_jax(topology, method, k, per):
    """Each topology, or the ring/naive it falls back to where its
    geometry does not hold, gives JAX's int32 values on every rank row,
    the selector's label naming what ran."""
    jm, pm = meshes(k)
    x = np.concatenate([host_data(per, "int32", rank=r, seed=2).numpy()
                        for r in range(k)])
    ref = np.asarray(jax_rings.make_topology_all_reduce(
        method, jm, AXIS, topology=topology)(
            jax_core.shard_payload(x, jm, AXIS)))
    got = port_rings.make_topology_all_reduce(method, pm, topology)(
        port.shard_payload(x, pm)).numpy()
    assert got.shape == (k, per)
    for row in got:
        assert np.array_equal(row, ref)
    assert np.array_equal(ref, port.host_collective_oracle(x, k, method))


def test_topology_leaves_its_input_alone():
    _, pm = meshes(8)
    for topology in ("ring", "bidir", "torus2d", "naive"):
        x = port.shard_payload(np.arange(8 * 64, dtype=np.int32), pm)
        before = x.clone()
        port_rings.make_topology_all_reduce("SUM", pm, topology)(x)
        assert torch.equal(x, before), topology


# ---------------------------------------------------------------------------
# the quant curve
# ---------------------------------------------------------------------------

CURVE_N = 4096


@pytest.mark.parametrize("k", [2, 4, 8])
def test_quant_curve_rows_are_the_jax_rows(k):
    """Every cell of the curve at ranks 2/4/8: the same row as JAX's
    measure_cell, byte for byte (algorithm, wire factors, bound, the
    measured error, status), and PASSED."""
    for method, dtype, bits, kk in port_qc.curve_cells(ranks=(k,)):
        got = port_qc.measure_cell(method, dtype, bits, kk, CURVE_N, 0,
                                   platform="cpu")
        ref = jax_qc.measure_cell(method, dtype, bits, kk, CURVE_N, 0)
        assert json.dumps(got, sort_keys=True) == json.dumps(
            ref, sort_keys=True), (method, dtype, bits, kk)
        assert got["status"] == "PASSED"


def test_quant_curve_grid_and_rows_grammar():
    assert port_qc.curve_cells() == jax_qc.curve_cells()
    assert port_qc.curve_cells((2, 8), bits=(8,)) == jax_qc.curve_cells(
        (2, 8), bits=(8,))
    assert QUANT_CURVE_HEADER == jax_qc.QUANT_CURVE_HEADER
    from tpu_reductions.utils.logging import quant_curve_row as jax_row
    for args in (("float32", "SUM", 8, 4, 3.94, 1.25e-3, 7.5e-2),
                 ("bfloat16", "MAX", 16, 64, 1.9, 0.0, 0.0),
                 ("float64", "sum", 4, 2, 7.0, 2.5e-7, 1e-3)):
        assert quant_curve_row(*args) == jax_row(*args)


def test_quant_curve_run_resumes_and_folds(tmp_path):
    out = tmp_path / "qc.json"
    rows = port_qc.run_curve(n=CURVE_N, seed=0, ranks=(2,), bits=(8,),
                             out=str(out), platform="cpu")
    data = json.loads(out.read_text())
    assert data["complete"] is True and data["rows"] == rows
    assert len(rows) == 7          # SUM x 3 dtypes, MIN and MAX x f32/f64
    data["complete"] = False
    data["rows"][0]["max_err"] = -1.0       # only a resumed row has this
    out.write_text(json.dumps(data))
    again = port_qc.run_curve(n=CURVE_N, seed=0, ranks=(2,), bits=(8,),
                              out=str(out), platform="cpu")
    assert again[0]["max_err"] == -1.0 and again[1:] == rows[1:]
    md = port_qc.quant_curve_markdown({"rows": rows})
    assert md == jax_qc.quant_curve_markdown({"rows": rows})
    assert "every measured error within its declared bound" in md
