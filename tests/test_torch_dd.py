"""The port's f64 pair route (tpu_reductions_torch/ops/dd_reduce.py and the
driver's --f64=dd) held against the JAX package's dd route, on the CPU.

The same numpy inputs go through both. The JAX kernel runs in interpret
mode (`interpret=True`), as tests/test_dd_reduce.py runs it; the port's
wrapper takes its plain version for CPU tensors. The encodings, the
(TM, 128) accumulators and the finished scalar pairs must be equal bit for
bit: the pair arithmetic is additions and selections, each rounded to
nearest in float32 or exact in int32, in the same order on both sides.
"""

import contextlib
import io
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_reductions.bench import driver as jax_driver
from tpu_reductions.config import ReduceConfig as JaxConfig
from tpu_reductions.ops import dd_reduce as jdd
from tpu_reductions.ops import oracle as jax_oracle
from tpu_reductions.utils import logging as jax_logging
from tpu_reductions.utils.rng import host_data as jax_host_data
from tpu_reductions_torch.bench import driver
from tpu_reductions_torch.config import ReduceConfig, parse_single_chip
from tpu_reductions_torch.ops import chain, dd_reduce as dd, oracle
from tpu_reductions_torch.ops.registry import get_op
from tpu_reductions_torch.utils import logging as port_logging
from tpu_reductions_torch.utils.qa import QAStatus
from tpu_reductions_torch.utils.timing import Stopwatch

REPO = Path(__file__).resolve().parents[1]
METHODS = ("SUM", "MIN", "MAX")
CPU = torch.device("cpu")


@pytest.fixture
def numpy_oracle(monkeypatch):
    """Both packages on their numpy payload and oracle (their native
    fillers give other data for the same seed)."""
    monkeypatch.setattr(jax_oracle, "_load", lambda: None)
    monkeypatch.setattr(oracle, "_load", lambda: None)


def bits(a) -> np.ndarray:
    """The 32-bit patterns of a float32/int32 array or tensor."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def payload(n, method, seed=0) -> np.ndarray:
    """The benchmark payload for SUM; signed, spread values for MIN/MAX."""
    if method == "SUM":
        return jax_host_data(n, "float64", seed=seed)
    return np.random.default_rng(seed).normal(size=n) * 1e10


# ---------------------------------------------------------------- encodings


@pytest.mark.parametrize("scale", [1e-300, 1e-30, 1.0, 1e30, 1e300])
def test_splits_bit_identical(scale):
    x = np.random.default_rng(3).uniform(-1, 1, 4097) * scale
    for port, ref in ((dd.host_split(x / scale), jdd.host_split(x / scale)),
                      (dd.host_split_scaled(x), jdd.host_split_scaled(x))):
        assert bits(port[0]).tolist() == bits(ref[0]).tolist()
        assert bits(port[1]).tolist() == bits(ref[1]).tolist()
        assert port[2:] == ref[2:]
    with pytest.raises(ValueError, match="non-finite"):
        dd.host_split_scaled(np.array([1.0, np.inf]))


def test_keys_bit_identical_and_invertible():
    x = np.concatenate([np.random.default_rng(4).normal(size=999) * 1e200,
                        [0.0, -0.0, 1e-320, -1e-320, 1.0, -1.0]])
    k_hi, k_lo = dd.host_key_encode(x)
    r_hi, r_lo = jdd.host_key_encode(x)
    np.testing.assert_array_equal(k_hi, r_hi)
    np.testing.assert_array_equal(k_lo, r_lo)
    back = dd.host_key_decode(k_hi, k_lo)
    np.testing.assert_array_equal(back.view(np.uint64), x.view(np.uint64))
    # signed lexicographic key order is the f64 order (-0.0 below +0.0)
    order = np.lexsort((k_lo, k_hi))
    assert np.all(np.diff(x[order]) >= 0)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n, threads, max_blocks", [
    (999, 32, 64), (65541, 16, 8), (300_000, 64, 4)])
def test_stage_split_padded_bit_identical(method, n, threads, max_blocks):
    x = payload(n, method, seed=n)
    port = dd.stage_split_padded(x, method, threads, max_blocks)
    ref = jdd.stage_split_padded(x, method, threads, max_blocks)
    np.testing.assert_array_equal(bits(port[0]), bits(ref[0]))
    np.testing.assert_array_equal(bits(port[1]), bits(ref[1]))
    assert port[2:] == ref[2:]


# ------------------------------------------------- accumulator and finishes


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n, threads, max_blocks", [
    (65541, 16, 8), (300_000, 16, 8), (20_001, 8, 64)])
def test_dd_call_bit_identical_to_pallas(method, n, threads, max_blocks):
    """The accumulator, the device finish's scalar pair and both host
    finishes, bit for bit."""
    x = payload(n, method, seed=n + 1)
    hi, lo, (tm, _, _), s = jdd.stage_split_padded(x, method, threads,
                                                   max_blocks)
    ref = jdd.dd_pallas_call(jnp.asarray(hi), jnp.asarray(lo), method, tm,
                             interpret=True)
    before = dd.dd_call.launches
    got = dd.dd_call(torch.from_numpy(hi), torch.from_numpy(lo), method, tm)
    assert dd.dd_call.launches == before       # the plain version
    for g, r in zip(got, ref):
        assert g.shape == (tm, 128)
        np.testing.assert_array_equal(bits(g), bits(r))
    ref_pair = jax.jit(lambda a, b: jdd.device_finish_pairs(a, b, method))(
        *ref)
    got_pair = dd.device_finish_pairs(*got, method)
    for g, r in zip(got_pair, ref_pair):
        assert g.shape == ()
        assert bits(g).tolist() == bits(r).tolist()
    assert dd.decode_pair_scalar(*got_pair, method, s) == \
        jdd.decode_pair_scalar(*ref_pair, method, s)
    assert dd.host_finish_pairs(*got, method, s) == \
        jdd.host_finish_pairs(*ref, method, s)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n, threads, max_blocks", [
    (65541, 16, 8), (300_000, 16, 8), (20_001, 8, 64), (70_001, 24, 8)])
def test_dd_scalar_call_bit_identical_to_jax_core(method, n, threads,
                                                 max_blocks):
    """dd_scalar_call's plain version (device_finish_pairs of dd_plain)
    gives the scalar pair of the JAX package's jitted core (the Pallas
    kernel in interpret mode and its halving tree), bit for bit, at TM 16
    and 8 and at TM 24, whose 3072 pairs pad to 4096."""
    x = payload(n, method, seed=n + 2)
    j_stage, j_core, _ = jdd.make_dd_device_reduce(
        method, n, threads=threads, max_blocks=max_blocks, interpret=True)
    ref = j_core(*j_stage(x)[:2])
    hi, lo, (tm, _, _), _ = dd.stage_split_padded(x, method, threads,
                                                  max_blocks)
    before = dd.dd_call.launches
    got = dd.dd_scalar_call(torch.from_numpy(hi), torch.from_numpy(lo),
                            method, tm)
    assert dd.dd_call.launches == before       # the plain version
    for g, r in zip(got, ref):
        assert g.shape == ()
        assert bits(g).tolist() == bits(r).tolist()


def np_combine(method: str):
    """dd_add or dd_select on numpy arrays: float32 additions, each
    rounded to nearest, or int32 selections."""
    if method == "SUM":
        def add(h1, l1, h2, l2):
            s = h1 + h2
            bb = s - h1
            e = ((h1 - (s - bb)) + (h2 - bb)) + (l1 + l2)
            h = s + e
            return h, e - (h - s)
        return add
    minimum = method == "MIN"

    def select(h1, l1, h2, l2):
        take2 = (((h2 < h1) | ((h2 == h1) & (l2 < l1))) if minimum
                 else ((h2 > h1) | ((h2 == h1) & (l2 > l1))))
        return np.where(take2, h2, h1), np.where(take2, l2, l1)
    return select


def fold_rows(h, l, combine):
    """A halving tree over the first axis: row i takes row i + half."""
    while h.shape[0] > 1:
        half = h.shape[0] // 2
        h, l = combine(h[:half], l[:half], h[half:], l[half:])
    return h[0], l[0]


def kernel_tree_walk(acc_hi, acc_lo, method, residues):
    """csrc/pair.cu's pair finish walked on the host: the accumulator
    flattened and padded to a power of two with the pad pair; pass-2
    thread r of `residues` folds its leaves r + j residues in registers;
    thread t of the last CTA folds the tree's pairs t + i DD_TEAM in
    registers; shared memory folds t with t + half down to one warp; the
    warp folds by shuffles, lane t taking lane t + half's pair."""
    combine = np_combine(method)
    pads = dd.pad_pair(method)
    size = acc_hi.size
    padded = 1 << (size - 1).bit_length()
    h = np.full(padded, pads[0], dtype=acc_hi.dtype)
    l = np.full(padded, pads[1], dtype=acc_lo.dtype)
    h[:size], l[:size] = acc_hi.ravel(), acc_lo.ravel()
    # pass 2: slot r + j residues is row j, column r
    h, l = fold_rows(h.reshape(-1, residues), l.reshape(-1, residues),
                     combine)
    # the last CTA's registers: pair t + i DD_TEAM is row i, column t
    h, l = fold_rows(h.reshape(-1, dd.DD_TEAM), l.reshape(-1, dd.DD_TEAM),
                     combine)
    half = dd.DD_TEAM // 2
    while half >= 32:                       # shared memory
        h, l = combine(h[:half], l[:half], h[half:2 * half],
                       l[half:2 * half])
        half //= 2
    h, l = h.copy(), l.copy()
    for half in (16, 8, 4, 2, 1):           # __shfl_down_sync
        down = np.arange(32) + half
        down[down >= 32] = np.arange(32)[down >= 32]
        nh, nl = combine(h, l, h[down], l[down])
        take = np.arange(32) < half
        h, l = np.where(take, nh, h), np.where(take, nl, l)
    return h[0], l[0]


def pair_accumulator(method, tm, seed):
    """A (TM, 128) pair accumulator whose tree sums depend on their
    order: SUM pairs over 40 binades, hi + lo normalised; MIN/MAX keys
    with hi ties that lo must break."""
    rng = np.random.default_rng(seed)
    if method == "SUM":
        x = rng.standard_normal((tm, 128)) * 2.0 ** rng.integers(
            -20, 20, (tm, 128))
        hi, lo = dd.host_split(x)
        return hi, lo
    hi = rng.integers(-4, 4, (tm, 128)).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, (tm, 128)).astype(np.int32)
    return hi, lo


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("tm, residues", [
    (8, 256), (8, 1024), (24, 256), (24, 1024), (200, 1024), (200, 8192),
    (256, 2048), (256, 4096), (256, 8192), (2048, 8192)])
def test_kernel_tree_schedule_is_the_halving_tree(method, tm, residues):
    """The kernel's schedule (residue classes in pass 2, in-register,
    shared-memory and shuffle levels in the last CTA, the padding) gives
    the pair of device_finish_pairs (halving_tree) bit for bit, at TMs of
    2^10 to 2^18 pairs, padded or not, and several numbers of pass-2
    threads, plan_dd's among them."""
    hi, lo = pair_accumulator(method, tm, seed=tm + residues)
    got = kernel_tree_walk(hi, lo, method, residues)
    want = dd.device_finish_pairs(torch.from_numpy(hi), torch.from_numpy(lo),
                                  method)
    assert [bits(np.asarray(g)).tolist() for g in got] == \
        [bits(w).tolist() for w in want]


def test_tree_walk_tells_orders_apart():
    """The SUM accumulators above are order-sensitive, so the walk's
    equality is not vacuous: handing each pass-2 thread a contiguous
    block of slots instead of a residue class gives other bits."""
    combine = np_combine("SUM")
    differ = []
    for seed in range(5):
        hi, lo = pair_accumulator("SUM", 256, seed)
        want = fold_rows(hi.ravel(), lo.ravel(), combine)
        blocks = [p.reshape(4096, -1).T.copy() for p in (hi, lo)]
        got = fold_rows(*fold_rows(*blocks, combine), combine)
        differ.append(bits(np.asarray(got)).tolist()
                      != bits(np.asarray(want)).tolist())
    assert any(differ)


@pytest.mark.parametrize("method", METHODS)
def test_entry_points_match_jax(method):
    """make_dd_device_reduce, make_dd_staged_reduce and the one-shot
    dd_reduce_f64 give the JAX values on the same payload."""
    n = 70_001
    x = payload(n, method, seed=9)
    j_stage, j_core, j_finish = jdd.make_dd_device_reduce(
        method, n, threads=32, max_blocks=8, interpret=True)
    j_hi, j_lo, j_s = j_stage(x)
    want = j_finish(*j_core(j_hi, j_lo), scale_exp=j_s)
    stage, core, finish = dd.make_dd_device_reduce(
        method, n, threads=32, max_blocks=8, device=CPU)
    hi2d, lo2d, s = stage(torch.from_numpy(x))
    assert s == j_s and hi2d.device == CPU
    assert finish(*core(hi2d, lo2d), scale_exp=s) == want

    j_stage2, j_reduce = jdd.make_dd_staged_reduce(
        method, n, threads=32, max_blocks=8, interpret=True)
    want_host = j_reduce(*j_stage2(x))
    stage2, reduce2 = dd.make_dd_staged_reduce(method, n, threads=32,
                                               max_blocks=8, device=CPU)
    assert reduce2(*stage2(x)) == want_host
    assert dd.dd_reduce_f64(x, method, threads=32, max_blocks=8,
                            device="cpu") == \
        jdd.dd_pallas_reduce_f64(x, method, threads=32, max_blocks=8,
                                 interpret=True)


def test_adversarial_cancellation():
    """Alternating large and small magnitudes, where a float32 sum loses
    everything: 1e-13 relative, as tests/test_dd_reduce.py holds JAX."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, 32_768)
    x[::2] *= 1e6
    exact = math.fsum(x.tolist())
    got = float(dd.dd_sum_f64(torch.from_numpy(x), threads=32))
    assert abs(got - exact) / abs(exact) < 1e-13


@pytest.mark.parametrize("scale", [1e300, 1e-300])
def test_full_range_sum(scale):
    x = np.random.default_rng(11).uniform(-1, 1, 4097) * scale
    exact = math.fsum(x.tolist())
    got = float(dd.dd_reduce_f64(x, "SUM", threads=32, device="cpu"))
    assert abs(got - exact) <= 1e-12 * max(abs(exact),
                                           float(np.abs(x).max()))


@pytest.mark.parametrize("method", ["SUM", "MIN"])
def test_pair_chain_leaves_planes_staged(method):
    """The pair form of the chain: the staged planes stay as staged,
    chained(x, 1) is one reduce, and the chain really folds its scalar
    into its own copy of the first plane."""
    n = 8192 + 3
    x = np.random.default_rng(5).uniform(-1, 1, n)
    stage, core, _ = dd.make_dd_device_reduce(method, n, threads=32,
                                              device=CPU)
    hi2d, lo2d, _ = stage(x)
    before = (hi2d.clone(), lo2d.clone())
    chained = chain.make_chained_reduce(core, get_op(method))
    once = core(hi2d, lo2d)[0]
    assert bits(chained((hi2d, lo2d), 1)).tolist() == bits(once).tolist()
    four = chained((hi2d, lo2d), 4)
    if method == "SUM":
        assert float(four) != float(once)
    else:
        assert bits(four).tolist() == bits(once).tolist()   # a fixpoint
    assert torch.equal(hi2d, before[0]) and torch.equal(lo2d, before[1])


# ------------------------------------------------------------- the driver


def _logger():
    return port_logging.BenchLogger(console=io.StringIO())


DRIVER_CASES = [  # (method, cpu_final, timing)
    ("SUM", False, "periter"), ("MIN", False, "periter"),
    ("MAX", False, "periter"), ("SUM", True, "periter"),
    ("SUM", False, "chained"), ("MAX", False, "chained")]


@pytest.mark.parametrize("method, cpu_final, timing", DRIVER_CASES)
def test_driver_dd_route_matches_jax(numpy_oracle, monkeypatch, method,
                                     cpu_final, timing):
    """--type=double --f64=dd: the device value is the JAX dd route's, the
    oracle the JAX driver's, and the row PASSES with kernel 6's label and
    8 bytes an element."""
    real = driver.time_chained

    def positive_slope(*args, **kwargs):
        sw = real(*args, **kwargs)
        if sw.average_s <= 0:   # host noise at test scale
            sw = Stopwatch(total_s=1e-4, sessions=1, samples=[1e-4])
        return sw

    monkeypatch.setattr(driver, "time_chained", positive_slope)
    fields = dict(method=method, dtype="float64", n=65541, threads=16,
                  max_blocks=8, cpu_final=cpu_final, iterations=2,
                  log_file=None)
    port = driver.run_benchmark(
        ReduceConfig(platform="cpu", f64="dd", timing=timing,
                     chain_reps=2, **fields), logger=_logger())
    jax_res = jax_driver.run_benchmark(
        JaxConfig(**fields),
        logger=jax_logging.BenchLogger(console=io.StringIO()))
    x = jax_host_data(fields["n"], "float64")
    if cpu_final:
        stage, reduce_fn = jdd.make_dd_staged_reduce(
            method, fields["n"], threads=16, max_blocks=8, interpret=True)
        want = reduce_fn(*stage(x))
    else:
        stage, core, finish = jdd.make_dd_device_reduce(
            method, fields["n"], threads=16, max_blocks=8, interpret=True)
        hi, lo, s = stage(x)
        want = finish(*core(hi, lo), scale_exp=s)
    assert port.device_result == float(want)
    assert port.oracle_result == jax_res.oracle_result
    assert port.status == jax_res.status == QAStatus.PASSED
    assert port.timing == timing and port.kernel == 6
    assert ReduceConfig(dtype="float64", f64="dd").nbytes == 8 * (1 << 24)


@pytest.mark.parametrize("kernel, backend, reason", [
    (7, "auto", "kernel-7 label"), (8, "auto", "kernel-8 label"),
    (10, "cuda", "kernel-10 label"),
    (9, "auto", "kernel 9 (MXU) is SUM over float dtypes only"),
    (6, "torch", "no native f64 on the dd route; use backend=cuda")])
def test_driver_dd_route_waives(kernel, backend, reason):
    """The JAX driver's gates on its dd route: k9 loses float64, kernels
    7, 8 and 10 would mislabel a pair-kernel row, the torch comparator
    has no f64 there."""
    res = driver.run_benchmark(
        ReduceConfig(method="SUM", dtype="float64", n=4096, kernel=kernel,
                     backend=backend, f64="dd", platform="cpu",
                     log_file=None), logger=_logger())
    assert res.status == QAStatus.WAIVED
    assert reason in res.waived_reason
    if kernel in (7, 8, 10):
        assert "pair kernel (kernel-6 structure)" in res.waived_reason


def test_f64_flag_ignored_by_other_dtypes_and_native_default():
    """--f64=dd on int32 runs k6; float64's default route is native, where
    kernel 9 runs float64."""
    res = driver.run_benchmark(
        ReduceConfig(method="SUM", dtype="int32", n=4096, f64="dd",
                     platform="cpu", iterations=2, log_file=None),
        logger=_logger())
    assert res.status == QAStatus.PASSED and res.kernel == 6
    assert parse_single_chip(["--method=SUM"])[0].f64 == "native"
    res = driver.run_benchmark(
        ReduceConfig(method="SUM", dtype="float64", n=4096, kernel=9,
                     platform="cpu", iterations=2, log_file=None),
        logger=_logger())
    assert res.status == QAStatus.PASSED
    err = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
        parse_single_chip(["--method=SUM", "--f64=quad"])
    assert "invalid choice" in err.getvalue()
    with pytest.raises(ValueError, match="f64 must be one of"):
        ReduceConfig(f64="quad")


def test_cli_dd_route_passes(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch", "--method=SUM",
         "--type=double", "--f64=dd", "--n=65541", "--threads=16",
         "--platform=cpu", "--iterations=3",
         f"--logfile={tmp_path / 'r.txt'}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "&&&& tpu_reductions_torch PASSED"
    assert any(ln.startswith("Reduction, Throughput = ") for ln in lines)
