"""The port's reduction family (ops/family/, the family rows of the
registry, the oracle and the row grammar, bench/family_spot.py) held
against the JAX package's on the same numpy inputs, on the CPU.

Tolerances: int32 is exact everywhere (scans and segment sums wrap modulo
2^32 on both sides); MIN/MAX, segment extremes and arg indices are exact
selections; float32 scans and segment sums add in another order than
XLA's, so they are held to `tolerance("SUM", "float32", n)`, the
benchmark's own rule (1e-8 n), against the float64 host oracle. The host
oracles, `IncrementalOracle` and the offsets are numpy on both sides and
must be equal.
"""

import io
import json

import numpy as np
import pytest
import torch

from tpu_reductions import config as jax_config
from tpu_reductions.bench import family_spot as jax_family_spot
from tpu_reductions.lint import grammar as jax_grammar
from tpu_reductions.ops import family as jax_fam
from tpu_reductions.ops import oracle as jax_oracle
from tpu_reductions.ops import registry as jax_registry
from tpu_reductions.utils import logging as jax_logging
from tpu_reductions_torch import config
from tpu_reductions_torch.bench import family_spot, regen
from tpu_reductions_torch.ops import family as fam
from tpu_reductions_torch.ops import oracle, registry
from tpu_reductions_torch.utils import logging as port_logging
from tpu_reductions_torch.utils.logging import BenchLogger
from tpu_reductions_torch.utils.rng import host_data

CPU = torch.device("cpu")
F32_TOL = registry.tolerance("SUM", "float32", 1)   # per element: 1e-8 n


def wrap_payload(n: int = 4096, seed: int = 1) -> np.ndarray:
    """int32 values whose running sum crosses 2^31 several times."""
    return np.random.default_rng(seed).integers(
        2**20, 2**24, size=n).astype(np.int32)


def f32_payload(n: int = 4096, seed: int = 2) -> np.ndarray:
    """The benchmark's float32 payload (bytes / RAND_MAX, numpy-made),
    the data SUM's absolute tolerance of 1e-8 n is set for."""
    return host_data(n, "float32", seed=seed).numpy()


# ------------------------------------------------------------------ tables

def test_method_tables_match():
    assert config.FAMILY_METHODS == jax_config.FAMILY_METHODS
    assert config.SERVED_METHODS == jax_config.SERVED_METHODS
    assert set(registry.FAMILY_OPS) == set(jax_registry.FAMILY_OPS)
    assert fam.SCAN_IMPLS == jax_fam.SCAN_IMPLS
    assert fam.SEG_BASE == jax_fam.SEG_BASE


@pytest.mark.parametrize("method", jax_config.SERVED_METHODS)
def test_get_op_and_tolerance_match(method):
    assert registry.get_op(method).name == jax_registry.get_op(method).name
    for dtype in ("int32", "float32", "float64", "bfloat16"):
        for n in (1, 1000):
            assert registry.tolerance(method, dtype, n) == \
                jax_registry.tolerance(method, dtype, n)
    for dtype in (torch.int32, torch.float32):
        np_dt = np.dtype(str(dtype).split(".")[-1])
        assert registry.get_op(method).identity(dtype) == \
            jax_registry.get_op(method).identity(np_dt)


def test_unknown_method_is_refused():
    with pytest.raises(ValueError, match="unknown reduction"):
        registry.get_op("MEDIAN")


@pytest.mark.parametrize("method", ["SCAN", "SEGSUM", "ARGMAX", "SUM"])
def test_surface_ids_and_family_test_match(method):
    assert fam.is_family_method(method) == jax_fam.is_family_method(method)
    if method != "SUM":
        assert fam.family_surface(method) == jax_fam.family_surface(method)
        assert fam.family_surface(method, "mxu-scan") == \
            jax_fam.family_surface(method, "mxu-scan")
    else:
        with pytest.raises(ValueError):
            fam.family_surface(method)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
def test_scan_impls_match(dtype):
    import ml_dtypes  # noqa: F401  (numpy's bfloat16 for the JAX side)
    assert fam.scan_impls(dtype) == jax_fam.scan_impls(dtype)


def test_family_row_grammar_is_byte_identical():
    assert port_logging.FAMILY_HEADER == jax_grammar.FAMILY_HEADER
    for args in (("int32", "scan", "xla-cumsum", 4096, 12.3456, "PASSED"),
                 ("float32", "ARGMAX", "argk", 1 << 24, 0.0, "FAILED"),
                 ("bfloat16", "SEGMIN", "seg", 7, 3e3, "PASSED")):
        row = port_logging.family_row(*args)
        assert row == jax_logging.family_row(*args)
        assert jax_grammar.FAMILY_ROW_RE.match(row)


# -------------------------------------------------------------------- SCAN

def test_int32_scan_is_bit_exact_through_the_wrap():
    x = wrap_payload()
    assert int(x.astype(np.int64).sum()) > 2**31
    want = np.asarray(jax_fam.scan_fn("xla-cumsum", "int32")(x, np.int32(0)))
    got = fam.scan_fn("xla-cumsum", "int32")(
        torch.from_numpy(x), torch.zeros((), dtype=torch.int32)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fam.host_scan(x))
    np.testing.assert_array_equal(fam.host_scan(x), jax_fam.host_scan(x))


def test_int32_stream_scanner_is_bit_exact_through_the_wrap():
    x = wrap_payload(n=128 * 8 * 5 + 3)
    chunk = 128 * 8 * 4           # one (8, 128) block of int32 a chunk
    scanner = fam.StreamScanner("int32", x.size, chunk_bytes=chunk,
                                device=CPU)
    assert scanner.plan.num_chunks == 6
    got = scanner.scan(x)
    jax_scanner = jax_fam.StreamScanner("int32", x.size, chunk_bytes=chunk)
    np.testing.assert_array_equal(got, jax_scanner.scan(x))
    np.testing.assert_array_equal(got, fam.host_scan(x))
    assert scanner.carry == got[-1] == jax_scanner.carry


@pytest.mark.parametrize("impl", ["xla-cumsum", "mxu-scan"])
def test_float32_scan_within_sum_tolerance(impl):
    x = f32_payload(n=5000)
    tol = registry.tolerance("SUM", "float32", x.size)
    got = fam.scan_fn(impl, "float32")(
        torch.from_numpy(x), torch.zeros((), dtype=torch.float32)).numpy()
    want = np.asarray(jax_fam.scan_fn(impl, "float32")(x, np.float32(0)))
    assert got.shape == want.shape == (x.size,)
    host = fam.host_scan(x)
    assert np.abs(got - host).max() <= tol
    assert np.abs(got.astype(np.float64) - want).max() <= tol
    scanner = fam.StreamScanner("float32", x.size, impl=impl,
                                chunk_bytes=128 * 8 * 4, device=CPU)
    assert np.abs(scanner.scan(x) - host).max() <= tol


@pytest.mark.parametrize("impl", ["xla-cumsum", "mxu-scan"])
def test_scan_rows_match(impl):
    x = f32_payload(n=3 * 300).reshape(3, 300)
    got = fam.scan_rows_fn(impl, "float32")(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_fam.scan_rows_fn(impl, "float32")(x))
    np.testing.assert_allclose(got, want, atol=F32_TOL * 300)


def test_mxu_scan_refuses_integers():
    with pytest.raises(ValueError, match="float-only"):
        fam.scan_fn("mxu-scan", "int32")
    with pytest.raises(ValueError, match="unknown scan impl"):
        fam.scan_fn("prefix-tree", "float32")


def test_mxu_scan_restores_the_matmul_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        fam.scan_fn("mxu-scan", "float32")(torch.ones(300),
                                           torch.zeros(()))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)


# --------------------------------------------------------------- segments

def test_offsets_and_ids_match():
    for n, s, seed in ((1000, 16, 0), (4096, 64, 3), (10, 8, 1)):
        off = fam.random_offsets(n, s, seed)
        np.testing.assert_array_equal(off, jax_fam.random_offsets(n, s, seed))
        ids = fam.segment_ids_from_offsets(off)
        np.testing.assert_array_equal(
            ids, jax_fam.segment_ids_from_offsets(off))
        assert ids.dtype == np.int32
    with pytest.raises(ValueError, match="monotone"):
        fam.segment_ids_from_offsets(np.array([0, 5, 3]))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("method", ["SEGSUM", "SEGMIN", "SEGMAX"])
def test_segments_match_with_empty_ones_as_identities(method, dtype):
    n, s = 4096, 64
    x = wrap_payload(n) if dtype == "int32" else \
        np.random.default_rng(4).standard_normal(n).astype(np.float32)
    offsets = fam.random_offsets(n, s, 3)
    empty = np.diff(offsets) == 0
    assert empty.any()
    ids = fam.segment_ids_from_offsets(offsets)
    got = fam.segment_reduce_fn(method, s)(
        torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    want = np.asarray(jax_fam.segment_reduce_fn(method, s)(x, ids))
    identity = registry.get_op(fam.SEG_BASE[method]).identity(
        getattr(torch, dtype))
    assert (got[empty] == identity).all()
    host = fam.host_segment_reduce(x, offsets, method)
    np.testing.assert_array_equal(
        host, jax_fam.host_segment_reduce(x, offsets, method))
    if method == "SEGSUM" and dtype == "float32":
        tol = registry.tolerance("SUM", dtype, n)
        assert np.abs(got - want).max() <= tol
        assert np.abs(got - host).max() <= tol
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.astype(np.float64), host)


# -------------------------------------------------------------------- ARG*

ARG_CASES = [
    # (values, dtype, ARGMIN index, ARGMAX index)
    ([3.0, -0.0, 0.0, -0.0, 5.0, 5.0], "float32", 1, 4),
    ([0.0, -0.0, 2.0, 2.0], "float32", 1, 2),
    ([7, -2**31, 4, -2**31, 2**31 - 1, 2**31 - 1], "int32", 1, 4),
    ([1, 1, 1, 1], "int32", 0, 0),
    ([-1.5, -1.5, -3.25, -3.25, 8.0], "float32", 2, 4),
]


@pytest.mark.parametrize("values, dtype, amin, amax", ARG_CASES)
def test_arg_ties_go_to_the_lowest_index(values, dtype, amin, amax):
    x = np.array(values, dtype=dtype)
    for method, want in (("ARGMIN", amin), ("ARGMAX", amax)):
        got = fam.arg_reduce_fn(method, dtype)(torch.from_numpy(x))
        assert got.dtype == torch.int32
        assert int(got) == want
        assert int(jax_fam.arg_reduce_fn(method, dtype)(x)) == want
        rows = fam.arg_reduce_rows_fn(method, dtype)(
            torch.from_numpy(np.stack([x, x[::-1].copy()])))
        jrows = np.asarray(jax_fam.arg_reduce_rows_fn(method, dtype)(
            np.stack([x, x[::-1].copy()])))
        np.testing.assert_array_equal(rows.numpy(), jrows)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_order_key_matches(dtype):
    x = np.array([-0.0, 0.0, -1.0, 1.0, -3e38, 3e38], dtype=np.float32) \
        if dtype == "float32" else np.array([-2**31, 0, 2**31 - 1], np.int32)
    np.testing.assert_array_equal(fam.order_key(x), jax_fam.order_key(x))
    with pytest.raises(ValueError):
        fam.order_key(np.ones(3))


def test_arg_reduce_refuses_other_methods_and_dtypes():
    with pytest.raises(ValueError, match="not an arg method"):
        fam.arg_reduce_fn("MIN", "float32")
    with pytest.raises(ValueError, match="int32/float32"):
        fam.arg_reduce_fn("ARGMIN", "float64")(torch.ones(3,
                                                          dtype=torch.float64))


# ----------------------------------------------------------------- oracles

@pytest.mark.parametrize("method", ["SCAN", "ARGMIN", "ARGMAX"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_host_oracles_equal_jax(method, dtype):
    x = wrap_payload() if dtype == "int32" else f32_payload()
    x[7] = x.min()          # a tie
    got = oracle.host_reduce(x, method)
    want = jax_oracle.host_reduce(x, method)
    assert type(got) is type(want) and got == want
    assert oracle.host_reduce(torch.from_numpy(x), method) == want
    assert fam.host_arg_reduce(x, "ARGMIN") == \
        jax_fam.host_arg_reduce(x, "ARGMIN")


@pytest.mark.parametrize("method", ["SCAN", "ARGMIN", "ARGMAX"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_incremental_oracle_equals_jax(method, dtype):
    x = wrap_payload(n=1000) if dtype == "int32" else f32_payload(n=1000)
    x[900] = x[:100].min()   # a tie across chunks: the earlier one wins
    x[950] = x[:100].max()
    port = oracle.IncrementalOracle(method, dtype)
    ref = jax_oracle.IncrementalOracle(method, dtype)
    for start in range(0, x.size, 128):
        port.update(torch.from_numpy(x[start:start + 128]))
        ref.update(x[start:start + 128])
    assert port.value() == ref.value()
    assert type(port.value()) is type(ref.value())
    assert port.state() == ref.state()
    again = oracle.IncrementalOracle.from_state(
        json.loads(json.dumps(port.state())))
    assert again.value() == port.value()
    if method != "SCAN":
        assert port.value() == oracle.host_reduce(x, method)


# ------------------------------------------------------------ family_spot

def test_family_cells_are_the_jax_cells_without_serving():
    # the serving rows are ported now: the grids are equal, serving
    # rows included
    assert family_spot.family_cells() == jax_family_spot.family_cells()
    assert family_spot.SERVE_CELLS == jax_family_spot.SERVE_CELLS


@pytest.mark.parametrize("cell", [c for c in jax_family_spot.family_cells()
                                  if c[0] == "cell"],
                         ids=lambda c: "-".join(c[1:]))
def test_measure_cell_matches_jax(cell, monkeypatch):
    _kind, method, dtype, impl = cell
    n, seg, seed = 2048, 16, 0
    want = jax_family_spot.measure_cell(method, dtype, impl, n, seg, seed,
                                        reps=1)
    got = family_spot.measure_cell(method, dtype, impl, n, seg, seed, 1, CPU)
    assert list(got) == list(want)
    assert got["status"] == want["status"] == "PASSED"
    for key in ("kind", "method", "dtype", "impl", "n", "segments"):
        assert got[key] == want[key], key
    # the JAX span at most: cut to about 6 ms of the digest's own time
    assert 8 <= got["span"] <= want["span"]
    if dtype == "int32" or method not in ("SCAN", "SEGSUM"):
        assert got["max_err"] == want["max_err"] == 0.0


def test_a_cell_that_disagrees_fails(monkeypatch):
    real = family_spot._cell_fns

    def off_by_one(*args):
        full, core, offsets = real(*args)
        return (lambda x: full(x) + 1), core, offsets

    monkeypatch.setattr(family_spot, "_cell_fns", off_by_one)
    row = family_spot.measure_cell("SCAN", "int32", "xla-cumsum", 1024, 8,
                                   0, 1, CPU)
    assert row["status"] == "FAILED" and row["max_err"] == 1.0


def test_family_spot_cli_writes_rows_and_resumes(tmp_path, capsys,
                                                 monkeypatch):
    out = tmp_path / "family_spot.json"
    argv = ["--n=2048", "--segments=8", "--reps=1", "--platform=cpu",
            f"--out={out}"]
    assert family_spot.main(argv) == 0
    text = capsys.readouterr().out
    assert text.splitlines()[0] == port_logging.FAMILY_HEADER
    data = json.loads(out.read_text())
    assert data["complete"] is True
    assert len(data["rows"]) == len(family_spot.family_cells())
    for row in data["rows"]:
        line = port_logging.family_row(row["dtype"], row["method"],
                                       row["impl"], row["n"], row["gbps"],
                                       row["status"])
        assert line in text and jax_grammar.FAMILY_ROW_RE.match(line)
    # an interrupted run: its rows are reused, not measured again
    data["complete"] = False
    data["rows"] = data["rows"][:4]
    out.write_text(json.dumps(data))
    measured = []
    real = family_spot.measure_cell
    monkeypatch.setattr(family_spot, "measure_cell",
                        lambda m, d, i, *a: measured.append((m, d, i))
                        or real(m, d, i, *a))
    assert family_spot.main(argv) == 0
    # the three serving rows go through measure_serve
    assert len(measured) == len(family_spot.family_cells()) - 4 - len(
        family_spot.SERVE_CELLS)
    assert measured[0] == tuple(family_spot.family_cells()[4][1:])


def test_family_spot_cli_exit_codes(monkeypatch):
    assert_refused = [["--n=1000"], ["--n=0"], ["--segments=1"],
                      ["--reps=0"]]
    for argv in assert_refused:
        with pytest.raises(SystemExit) as exc:
            family_spot.main(argv + ["--platform=cpu"])
        assert exc.value.code == 2
    monkeypatch.setattr(family_spot, "measure_cell",
                        lambda m, d, i, *a: {"kind": "cell", "method": m,
                                             "dtype": d, "impl": i, "n": 1,
                                             "gbps": 0.0, "max_err": 1.0,
                                             "status": "FAILED"})
    assert family_spot.main(["--n=1024", "--platform=cpu"]) == 1


def test_markdown_and_regen_fold(tmp_path):
    rows = [{"kind": "cell", "method": "SCAN", "dtype": "int32",
             "impl": "xla-cumsum", "n": 64, "gbps": 1.5, "max_err": 0.0,
             "status": "PASSED"}]
    data = {"n": 64, "rows": rows}
    md = family_spot.family_spot_markdown(data)
    assert "| SCAN | int32 | xla-cumsum | 1.500 | 0.000e+00 | PASSED |" in md
    assert family_spot.family_spot_markdown({"rows": []}) == ""
    (tmp_path / "shmoo.json").write_text("[]")
    (tmp_path / "family_spot.json").write_text(json.dumps(data))
    logs = []
    assert regen.regenerate(tmp_path, log=logs.append)
    assert md in (tmp_path / "report.md").read_text()
    assert any("reduction-family" in m for m in logs)


def test_run_family_spot_logs_the_header_first():
    buf = io.StringIO()
    rows = family_spot.run_family_spot(
        n=1024, segments=4, seed=0, reps=1, platform="cpu",
        logger=BenchLogger(console=buf))
    assert buf.getvalue().splitlines()[0] == port_logging.FAMILY_HEADER
    assert all(r["status"] == "PASSED" for r in rows)


def test_span_is_cut_to_the_digests_measured_time():
    """A digest far below the memory rate gets the shortest span; a fast
    one keeps the rate model's."""
    import time

    from tpu_reductions_torch.ops.chain import SPAN_MIN, auto_chain_span
    x2d = torch.zeros((64, 128), dtype=torch.int32)
    assert family_spot._span(lambda xx: time.sleep(0.02), x2d, "int32",
                             CPU) == SPAN_MIN
    fast = family_spot._span(lambda xx: xx[0, 0], x2d, "int32", CPU)
    assert SPAN_MIN <= fast <= auto_chain_span(x2d.numel(), "int32", "cpu")
