"""The port's exact collectives against the JAX package's, on the CPU.

The JAX constructors run on the 8 virtual CPU devices tests/conftest.py
provides; the port's run on its rank axis (k ranks as the rows of one
CPU tensor, tpu_reductions_torch/parallel/mesh.py), on the same numpy
payloads made from a seed (utils/rng.host_data gives both packages the
same bits).

- checks 1-5 of `__graft_entry__.dryrun_multichip` at k = 8, each against
  JAX's own value: the int32 all-reduce and reduce-scatter exact; root
  MIN exact on every rank row; the dd ring within 1e-12 of the oracle
  and its hi/lo planes bit-equal to JAX's ring on every rank row; the
  key-pair MIN exact; the chained SUM at k = 1 equal to the oracle's
  element 0, at k = 3 equal to JAX's chained scalar;
- a grid of method x rooted x k in {1, 2, 6, 8} x int32/float32/float64
  at a per-rank length that every k divides and at one that 6 and 8 do
  not: float32 SUM within the driver's tolerance (XLA's psum adds in its
  own order), everything else exact, float64 SUM included;
- ppermute, the ring and the accumulate-around-the-ring against JAX's;
- the registry (labels, wire factors, hop counts, costs) equal to JAX's
  over a grid of geometries and mode flags;
- the mesh's placement helpers and refusals with the JAX words.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_reductions.collectives import algorithms as jax_alg
from tpu_reductions.collectives import core as jax_core
from tpu_reductions.collectives import rings as jax_rings
from tpu_reductions.ops.dd_reduce import host_key_encode as jax_key_encode
from tpu_reductions.ops.dd_reduce import host_split as jax_host_split
from tpu_reductions.parallel import mesh as jax_mesh
from tpu_reductions.utils.rng import host_data as jax_host_data
from tpu_reductions_torch import collectives as port
from tpu_reductions_torch.collectives import algorithms as port_alg
from tpu_reductions_torch.collectives import rings as port_rings
from tpu_reductions_torch.ops.dd_reduce import (host_key_decode, host_key_encode,
                                                host_split)
from tpu_reductions_torch.ops.registry import get_op
from tpu_reductions_torch.parallel import mesh as port_mesh
from tpu_reductions_torch.utils.rng import host_data

AXIS = "ranks"
SUM_RTOL = {"float32": 1e-6}


def port_mesh_of(k):
    return port_mesh.build_mesh(num_devices=k, platform="cpu", local_ranks=8)


def payload(k, per, dtype, seed=0) -> np.ndarray:
    x = np.concatenate([host_data(per, dtype, rank=r, seed=seed).numpy()
                        for r in range(k)])
    ref = np.concatenate([np.asarray(jax_host_data(per, dtype, rank=r,
                                                   seed=seed))
                          for r in range(k)])
    assert np.array_equal(x, ref)      # both packages' payload bits
    return x


def jax_run(fn, *planes, mesh):
    out = fn(*[jax_core.shard_payload(p, mesh, AXIS) for p in planes])
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def port_run(coll, *planes, mesh):
    out = coll(*[port.shard_payload(p, mesh) for p in planes])
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


# ---------------------------------------------------------------------------
# dryrun_multichip's checks 1-5 at k = 8
# ---------------------------------------------------------------------------

K, PER = 8, 256


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh.build_mesh(num_devices=K), port_mesh_of(K)


@pytest.fixture(scope="module")
def xi():
    return payload(K, PER, "int32")


@pytest.fixture(scope="module")
def xf():
    return payload(K, PER, "float64")


def test_check1_int32_all_reduce_is_exact(meshes, xi):
    jm, pm = meshes
    ref = jax_run(jax_core.make_collective_reduce("SUM", jm, AXIS), xi,
                  mesh=jm)
    got = port_run(port.make_collective_reduce("SUM", pm), xi, mesh=pm)
    expect = port.host_collective_oracle(xi, K, "SUM")
    assert np.array_equal(ref, expect)
    assert got.shape == (K, PER)
    for row in got:                      # every replica
        assert np.array_equal(row, ref)


def test_check2_reduce_scatter_is_exact(meshes, xi):
    jm, pm = meshes
    ref = jax_run(jax_core.make_collective_reduce("SUM", jm, AXIS,
                                                  rooted="scatter"),
                  xi, mesh=jm)
    got = port_run(port.make_collective_reduce("SUM", pm, rooted="scatter"),
                   xi, mesh=pm)
    assert got.shape == (K, PER // K)
    assert np.array_equal(got.reshape(-1), ref)
    assert np.array_equal(got.reshape(-1),
                          port.host_collective_oracle(xi, K, "SUM"))


def test_check2b_root_min_is_exact_on_every_rank(meshes, xi):
    jm, pm = meshes
    out = jax_core.make_collective_reduce("MIN", jm, AXIS, rooted="root")(
        jax_core.shard_payload(xi, jm, AXIS))
    root_view = np.asarray([s.data for s in out.addressable_shards
                            if s.device == jm.devices.ravel()[0]][0])
    got = port_run(port.make_collective_reduce("MIN", pm, rooted="root"), xi,
                   mesh=pm)
    assert got.shape == (K, PER)
    for row in got:
        assert np.array_equal(row, root_view)


def test_check3_dd_ring_planes_are_jax_bits(meshes, xf):
    jm, pm = meshes
    hi, lo = host_split(xf)
    jhi, jlo = jax_host_split(xf)
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    ref_hi, ref_lo = jax_run(jax_core.make_dd_sum_all_reduce(jm, AXIS),
                             hi, lo, mesh=jm)
    got_hi, got_lo = port_run(port.make_dd_sum_all_reduce(pm), hi, lo,
                              mesh=pm)
    exact = xf.reshape(K, PER).sum(axis=0)
    for r in range(K):
        assert np.array_equal(got_hi[r].view(np.int32),
                              ref_hi.view(np.int32))
        assert np.array_equal(got_lo[r].view(np.int32),
                              ref_lo.view(np.int32))
        value = got_hi[r].astype(np.float64) + got_lo[r].astype(np.float64)
        assert np.allclose(value, exact, rtol=0, atol=1e-12)


def test_check4_key_pair_min_is_exact(meshes, xf):
    jm, pm = meshes
    k_hi, k_lo = host_key_encode(xf)
    jk_hi, jk_lo = jax_key_encode(xf)
    assert np.array_equal(k_hi, jk_hi) and np.array_equal(k_lo, jk_lo)
    ref = jax_run(jax_core.make_key_minmax_all_reduce("MIN", jm, AXIS),
                  k_hi, k_lo, mesh=jm)
    m_hi, m_lo = port_run(port.make_key_minmax_all_reduce("MIN", pm),
                          k_hi, k_lo, mesh=pm)
    for r in range(K):
        assert np.array_equal(m_hi[r], ref[0])
        assert np.array_equal(m_lo[r], ref[1])
        assert np.array_equal(host_key_decode(m_hi[r], m_lo[r]),
                              xf.reshape(K, PER).min(axis=0))


@pytest.mark.parametrize("rooted", ["none", "scatter", "root"])
def test_check5_chained_sum_is_jax_scalar(meshes, xi, rooted):
    jm, pm = meshes
    chained = jax_core.make_chained_collective("SUM", jm, AXIS, rooted=rooted)
    x_jax = jax_core.shard_payload(xi, jm, AXIS)
    pc = port.make_chained_collective("SUM", pm, rooted=rooted)
    x = port.shard_payload(xi, pm)
    staged = x.clone()
    one = int(pc(x, 1))
    assert one == int(port.host_collective_oracle(xi, K, "SUM")[0])
    assert one == int(np.asarray(chained(x_jax, 1)))
    many = int(pc(x, 3))
    assert many == int(np.asarray(chained(x_jax, 3)))
    assert many != one                   # each iteration really ran
    assert torch.equal(x, staged)        # the chain folds into a copy


@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
def test_chained_pair_collective_is_jax_scalar(meshes, xf, method):
    jm, pm = meshes
    if method == "SUM":
        hi, lo = host_split(xf)
        jfn = jax_core.make_dd_sum_all_reduce(jm, AXIS)
        pfn = port.make_dd_sum_all_reduce(pm)
    else:
        hi, lo = host_key_encode(xf)
        jfn = jax_core.make_key_minmax_all_reduce(method, jm, AXIS)
        pfn = port.make_key_minmax_all_reduce(method, pm)
    jchain = jax_core.make_chained_pair_collective(method, jfn)
    pchain = port.make_chained_pair_collective(method, pfn)
    jx = (jax_core.shard_payload(hi, jm, AXIS),
          jax_core.shard_payload(lo, jm, AXIS))
    px = (port.shard_payload(hi, pm), port.shard_payload(lo, pm))
    for k in (1, 3):
        want = np.asarray(jchain(jx, k))
        got = pchain(px, k).numpy()
        assert got.tobytes() == want.tobytes(), (k, got, want)


# ---------------------------------------------------------------------------
# the grid: method x rooted x k x dtype, two per-rank lengths
# ---------------------------------------------------------------------------

GRID = [(m, r, k, dt, per)
        for m in ("SUM", "MIN", "MAX")
        for r in ("none", "scatter", "root")
        for k in (1, 2, 6, 8)
        for dt in ("int32", "float32", "float64")
        for per in ((48, 50) if k in (6, 8) else (48,))]


@pytest.mark.parametrize("method, rooted, k, dtype, per", GRID,
                         ids=["-".join(map(str, g)) for g in GRID])
def test_collective_reduce_grid_matches_jax(method, rooted, k, dtype, per):
    jm = jax_mesh.build_mesh(num_devices=k)
    pm = port_mesh_of(k)
    x = payload(k, per, dtype, seed=5)
    ref = jax_run(jax_core.make_collective_reduce(method, jm, AXIS,
                                                  rooted=rooted), x, mesh=jm)
    coll = port.make_collective_reduce(method, pm, rooted=rooted)
    got = port_run(coll, x, mesh=pm)
    assert got.dtype == x.dtype
    label = port_alg.collective_algorithm(method, k, per, rooted)
    assert label == jax_alg.collective_algorithm(method, k, per, rooted)
    rows = [got.reshape(-1)] if not coll.replicated else list(got)
    if not coll.replicated:
        assert got.shape[0] == k
    for row in rows:
        assert row.shape == ref.shape
        if method == "SUM" and dtype == "float32":
            np.testing.assert_allclose(row, ref, rtol=SUM_RTOL[dtype])
        else:
            assert np.array_equal(row, ref)


@pytest.mark.parametrize("k, per", [(3, 10), (8, 40), (8, 13), (2, 7)])
def test_dd_sum_all_reduce_is_jax_bits(k, per):
    """The ring where k divides the per-rank length, the naive ring
    where it does not: both give JAX's bits on every rank row."""
    jm = jax_mesh.build_mesh(num_devices=k)
    pm = port_mesh_of(k)
    x = payload(k, per, "float64", seed=2)
    hi, lo = host_split(x)
    ref = jax_run(jax_core.make_dd_sum_all_reduce(jm, AXIS), hi, lo, mesh=jm)
    got = port_run(port.make_dd_sum_all_reduce(pm), hi, lo, mesh=pm)
    for r in range(k):
        for g, w in zip(got, ref):
            assert g[r].tobytes() == w.tobytes()


@pytest.mark.parametrize("method", ["MIN", "MAX"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_key_minmax_all_reduce_matches_jax(method, k):
    jm = jax_mesh.build_mesh(num_devices=k)
    pm = port_mesh_of(k)
    x = payload(k, 24, "float64", seed=3)
    x[5] = x[k * 24 - 1]             # ties on both words across ranks
    k_hi, k_lo = host_key_encode(x)
    ref = jax_run(jax_core.make_key_minmax_all_reduce(method, jm, AXIS),
                  k_hi, k_lo, mesh=jm)
    got = port_run(port.make_key_minmax_all_reduce(method, pm), k_hi, k_lo,
                   mesh=pm)
    for r in range(k):
        assert np.array_equal(got[0][r], ref[0])
        assert np.array_equal(got[1][r], ref[1])


def test_host_oracle_matches_jax():
    for dtype, method in itertools.product(("int32", "float32", "float64"),
                                           ("SUM", "MIN", "MAX")):
        x = payload(4, 33, dtype, seed=1)
        np.testing.assert_array_equal(
            port.host_collective_oracle(x, 4, method),
            jax_core.host_collective_oracle(x, 4, method))


def test_int32_sum_wraps_like_the_oracle():
    pm = port_mesh_of(4)
    x = np.full(4 * 6, 2**30, dtype=np.int32)
    got = port_run(port.make_collective_reduce("SUM", pm), x, mesh=pm)
    assert got.dtype == np.int32
    assert np.array_equal(got[0], port.host_collective_oracle(x, 4, "SUM"))
    assert got[0, 0] == 0           # 4 * 2^30 wraps to 0 mod 2^32


# ---------------------------------------------------------------------------
# rings
# ---------------------------------------------------------------------------

def test_ring_perm_and_grid_factors_match_jax():
    for k in range(1, 41):
        for sigma in (1, -1):
            assert port_rings.ring_perm(k, sigma) == \
                jax_rings.ring_perm(k, sigma)
        assert port_rings.grid_factors(k) == jax_rings.grid_factors(k)


PERMS = {
    "ring": [(i, (i + 1) % 8) for i in range(8)],
    "back": [(i, (i - 1) % 8) for i in range(8)],
    "butterfly": [(i, i ^ 2) for i in range(8)],
    "partial": [(0, 3), (5, 1), (7, 7)],
}


@pytest.mark.parametrize("name", sorted(PERMS))
def test_ppermute_matches_jax(name):
    perm = PERMS[name]
    jm = jax_mesh.build_mesh(num_devices=8)
    pm = port_mesh_of(8)
    x = payload(8, 16, "float32", seed=4)
    fn = jax.jit(jax_rings.shard_map(
        lambda s: jax.lax.ppermute(s, AXIS, perm), mesh=jm,
        in_specs=P(AXIS), out_specs=P(AXIS)))
    ref = np.asarray(fn(jax_core.shard_payload(x, jm, AXIS)))
    got = port_rings.ppermute(port.shard_payload(x, pm), perm, pm)
    assert np.array_equal(got.numpy().reshape(-1), ref)


@pytest.mark.parametrize("topology", ["ring", "naive"])
@pytest.mark.parametrize("k", [2, 5, 8])
def test_ring_and_naive_accumulate_match_jax(topology, k):
    """The port's ring_rs_ag and naive_accumulate with an int32 SUM
    combine against the JAX package's ring family on the same payload."""
    per = 40 if topology == "ring" else 13
    jm = jax_mesh.build_mesh(num_devices=k)
    pm = port_mesh_of(k)
    x = payload(k, per, "int32", seed=6)
    ref = np.asarray(jax_rings.make_topology_all_reduce(
        "SUM", jm, AXIS, topology=topology)(
            jax_core.shard_payload(x, jm, AXIS)))
    op = get_op("SUM")
    xs = port.shard_payload(x, pm)
    if topology == "ring":
        (got,) = port_rings.ring_rs_ag(
            pm, k, (xs.clone(),), to_wire=lambda ch: ch,
            absorb=lambda t, r: (op.combine(t[0], r[0]),),
            from_wire=lambda w: w)
    else:
        (got,) = port_rings.naive_accumulate(
            pm, k, (xs,), lambda a, r: (op.combine(a[0], r[0]),))
    for row in got.numpy():
        assert np.array_equal(row, ref)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_entries_match_jax():
    assert sorted(port_alg.REGISTRY) == sorted(jax_alg.REGISTRY)
    assert port_alg.ROOTED_MODES == jax_alg.ROOTED_MODES
    for name, alg in port_alg.REGISTRY.items():
        ref = jax_alg.REGISTRY[name]
        assert (alg.name, alg.dirs, alg.note) == (ref.name, ref.dirs,
                                                  ref.note)
        for k in (1, 2, 3, 6, 8, 12, 64, 1024):
            assert alg.wire_factor(k) == ref.wire_factor(k), (name, k)
            assert alg.steps(k) == ref.steps(k), (name, k)
            assert port_alg.WIRE_FACTORS[name](k) == \
                jax_alg.WIRE_FACTORS[name](k)


def _both(fn_name, *args, **kwargs):
    """(port's result or exception text, JAX's); a Selection as its
    field tuple."""
    out = []
    for mod in (port_alg, jax_alg):
        try:
            got = getattr(mod, fn_name)(*args, **kwargs)
        except ValueError as e:
            got = f"ValueError: {e}"
        out.append(dataclasses.astuple(got)
                   if dataclasses.is_dataclass(got) else got)
    return out


SELECT_GRID = list(itertools.product(
    ("SUM", "MIN", "MAX"), ("int32", "float32", "float64", "bfloat16"),
    (1, 2, 6, 8, 64), (256, 2048, 2050), ("none", "scatter", "root")))


@pytest.mark.parametrize("method, dtype, k, per, rooted", SELECT_GRID,
                         ids=["-".join(map(str, g)) for g in SELECT_GRID])
def test_select_algorithm_matches_jax(method, dtype, k, per, rooted):
    for flags in (dict(), dict(dd_planes=True), dict(quantized=True),
                  dict(quantized=True, bits=4), dict(quantized=True,
                                                     bits=16),
                  dict(topology="ring"), dict(topology="bidir"),
                  dict(topology="torus2d"), dict(topology="naive")):
        got, ref = _both("select_algorithm", method, dtype, k, per,
                         rooted=rooted, **flags)
        assert got == ref, flags
        if not isinstance(ref, str):
            name, payload_bytes = ref[0], per * k * 4
            assert port_alg.bandwidth_report(payload_bytes, k, 1e-3,
                                             algorithm=name) == \
                jax_alg.bandwidth_report(payload_bytes, k, 1e-3,
                                         algorithm=name)
            assert port_alg.algorithm_cost(name, k, payload_bytes, 2e-5,
                                           1e-11) == \
                jax_alg.algorithm_cost(name, k, payload_bytes, 2e-5, 1e-11)
    assert _both("collective_algorithm", method, k, per, rooted)[0] == \
        jax_alg.collective_algorithm(method, k, per, rooted)


def test_per_family_helpers_match_jax():
    for k, per in itertools.product((1, 2, 3, 4, 6, 8, 16), (7, 64, 256,
                                                             2048, 4096)):
        for name in ("dd_ring_algorithm", "q8_ring_algorithm"):
            assert _both(name, k, per)[0] == getattr(jax_alg, name)(k, per)
        for bits, dtype in itertools.product((4, 8, 16),
                                             ("float32", "bfloat16",
                                              "float64")):
            assert port_alg.quant_ring_algorithm(k, per, bits, dtype) == \
                jax_alg.quant_ring_algorithm(k, per, bits, dtype)
        for topo in ("ring", "bidir", "torus2d", "naive"):
            assert port_alg.topology_supported(topo, k, per) == \
                jax_alg.topology_supported(topo, k, per)
        for elem in (2, 4, 8):
            assert port_alg.choose_topology(k, per, elem) == \
                jax_alg.choose_topology(k, per, elem)
    for rooted in (False, True, "none", "scatter", "root", "bogus"):
        assert _both("normalize_rooted", rooted)[0] == \
            _both("normalize_rooted", rooted)[1]
    for rooted in ("none", "scatter", "root"):
        assert port_alg.bandwidth_report(1 << 20, 8, 1e-3, rooted=rooted) == \
            jax_alg.bandwidth_report(1 << 20, 8, 1e-3, rooted=rooted)
    assert _both("bandwidth_report", 1, 2, 1.0, algorithm="bogus")[0] == \
        _both("bandwidth_report", 1, 2, 1.0, algorithm="bogus")[1]


def test_quant_constants_match_jax():
    from tpu_reductions.collectives import quant as jq
    from tpu_reductions_torch.collectives import quant as pq
    for name in ("QUANT_BLOCK", "Q8_BLOCK", "QUANT_BITS", "KEY_BITS",
                 "SUM_DTYPES", "MINMAX_DTYPES"):
        assert getattr(pq, name) == getattr(jq, name), name
    for method, dtype, bits in itertools.product(
            ("SUM", "MIN", "MAX", "sum"), ("int32", "float32", "float64",
                                           "bfloat16"), (4, 8, 16, 12)):
        assert pq.quant_supported(method, dtype, bits) == \
            jq.quant_supported(method, dtype, bits)
        assert pq.quant_support_error(method, dtype, bits) == \
            jq.quant_support_error(method, dtype, bits)
    for k, per, bits in itertools.product((1, 2, 8), (256, 4096, 2048 * 3),
                                          (4, 8)):
        assert pq.quant_ring_applies(k, per, bits) == \
            jq.quant_ring_applies(k, per, bits)
    for bits in (4, 8, 16):
        assert pq.levels(bits) == jq.levels(bits)


def test_package_exports_the_ported_names():
    """collectives/__init__ re-exports the JAX package's names, the
    quantized constructors and the topology rings included, but its jax
    version shim `shard_map`."""
    import tpu_reductions.collectives as jax_pkg
    missing = set(port.__all__) - set(jax_pkg.__all__)
    assert not missing, missing
    assert set(jax_pkg.__all__) - set(port.__all__) == {"shard_map"}
    for name in port.__all__:
        assert getattr(port, name) is not None, name


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_placement_helpers_match_jax():
    devs = list(range(10))
    for mapping in ("default", "reversed", "interleaved"):
        assert port_mesh._order_devices(devs, mapping) == \
            jax_mesh._order_devices(devs, mapping)
    for n in (1, 2, 7, 8):
        assert port_mesh.coarsen_to_chips(devs[:n]) == \
            jax_mesh.coarsen_to_chips(devs[:n])
    with pytest.raises(ValueError, match="unknown mapping"):
        port_mesh._order_devices(devs, "spiral")


@pytest.mark.parametrize("kwargs", [
    dict(num_devices=9),
    dict(num_devices=5, mode="co"),
    dict(mesh_shape=(3, 3)),
    dict(mesh_shape=(2, 4), axis_names=("a",)),
    dict(mode="xx"),
])
def test_build_mesh_refusals_keep_the_jax_words(kwargs):
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.build_mesh(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port_mesh.build_mesh(platform="cpu", local_ranks=8, **kwargs)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(num_devices=4), dict(num_devices=4, mode="co"),
    dict(mesh_shape=(2, 4)), dict(mesh_shape=(8,), axis_names=("x",)),
    dict(num_devices=6, mapping="reversed"),
])
def test_build_mesh_shape_matches_jax(kwargs):
    jm = jax_mesh.build_mesh(**kwargs)
    pm = port_mesh.build_mesh(platform="cpu", local_ranks=8, **kwargs)
    assert pm.axis_names == tuple(jm.axis_names)
    assert pm.mesh_shape == tuple(jm.devices.shape)
    assert pm.k == jm.shape[jm.axis_names[0]]
    assert pm.owned == tuple(range(pm.k))      # one process holds them all
    assert not port.mesh_spans_processes(pm)


def test_default_rank_count_is_the_platforms_devices():
    """Without --devices, k is the platform's device count times the
    processes: 1 on the CPU, as JAX's default CPU client has."""
    pm = port_mesh.build_mesh(platform="cpu")
    assert pm.k == 1 and pm.k_local == 1
    inv = port_mesh.device_inventory("cpu")
    assert inv == {"platform": "cpu", "num_devices": 1, "num_processes": 1,
                   "process_index": 0, "device_kinds": ["cpu"]}
    assert port_mesh.initialize_distributed() is False
    assert port_mesh.initialize_distributed(num_processes=1) is False


def test_local_view_and_selection():
    pm = port_mesh_of(4)
    x = payload(4, 8, "int32")
    scatter = port.make_collective_reduce("MAX", pm, rooted="scatter")
    view, sel = port.local_view_and_selection(
        scatter(port.shard_payload(x, pm)), scatter)
    assert sel == slice(None) and view.shape == (8,)
    allr = port.make_collective_reduce("MAX", pm)
    out = allr(port.shard_payload(x, pm))
    assert np.array_equal(port.local_view(out, allr),
                          port.host_collective_oracle(x, 4, "MAX"))


def test_jnp_minimum_keeps_negative_zero_torch_takes_the_first():
    """Why hand-built inputs compare keys: torch.minimum(+0.0, -0.0) is
    its first argument, jnp.minimum -0.0 either way (host_data's payload
    has no negative zero)."""
    a, b = torch.tensor([0.0]), torch.tensor([-0.0])
    assert np.signbit(np.asarray(jnp.minimum(jnp.float32(0.0),
                                             jnp.float32(-0.0))))
    assert not torch.signbit(torch.minimum(a, b)).item()
