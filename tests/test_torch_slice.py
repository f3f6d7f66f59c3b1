"""The port's single-chip benchmark slice held against the JAX package, on
the CPU: payload, op table, oracle, output rows, the driver's results and
QA verdicts, the CLI, and chained timing.

Both packages fill and verify the payload with their native library
(csrc/oracle.cpp, built by g++ at first use) where it builds, and with
numpy otherwise; the two routes give different data for the same seed.
So a comparison puts both packages on the same route (tests/
torch_routes.py): the `numpy_oracle` fixture switches both native
libraries off, `use_route(..., "native")` holds both on, and the driver
comparison runs on each.
"""

import contextlib
import dataclasses
import io
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_reductions.bench import driver as jax_driver
from tpu_reductions.config import ReduceConfig as JaxConfig
from tpu_reductions.ops import oracle as jax_oracle
from tpu_reductions.ops import registry as jax_registry
from tpu_reductions.ops.pallas_reduce import pallas_reduce
from tpu_reductions.utils import logging as jax_logging
from tpu_reductions.utils import qa as jax_qa
from tpu_reductions.utils.rng import host_data as jax_host_data
from tpu_reductions_torch.bench import driver
from tpu_reductions_torch.config import ReduceConfig, parse_single_chip
from tpu_reductions_torch.ops import chain, kernel_reduce as kr
from tpu_reductions_torch.ops import oracle, registry
from tpu_reductions_torch.utils import logging as port_logging
from tpu_reductions_torch.utils import qa as port_qa
from tpu_reductions_torch.utils.qa import QAStatus
from tpu_reductions_torch.utils.rng import host_data
from tpu_reductions_torch.utils.timing import Stopwatch
from torch_routes import numpy_oracle, use_route  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
DTYPES = ("int32", "float32", "float64", "bfloat16")


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_data_bit_identical(dtype):
    for n, rank, seed in ((1000, 0, 0), (65537, 1, 2), (4096 + 7, 0, 9)):
        want = jax_host_data(n, dtype, rank=rank, seed=seed)
        got = host_data(n, dtype, rank=rank, seed=seed)
        if dtype == "bfloat16":
            want = want.view(np.int16)
        np.testing.assert_array_equal(_bits(got), want)


def test_bfloat16_rounding_matches_on_every_payload_value():
    reals = np.arange(256) / float(2**31 - 1)
    np.testing.assert_array_equal(
        torch.from_numpy(reals).to(torch.bfloat16).view(torch.int16).numpy(),
        reals.astype(ml_dtypes.bfloat16).view(np.int16))


def test_tolerance_and_identities_agree():
    for method in ("SUM", "MIN", "MAX"):
        for dtype in ("int32", "int64", "float32", "float64", "bfloat16"):
            for n in (1, 1000, 1 << 24):
                assert registry.tolerance(method, dtype, n) == \
                    jax_registry.tolerance(method, dtype, n)
        for dtype in DTYPES:
            np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
            want = jax_registry.get_op(method).identity(np_dtype)
            got = registry.get_op(method).identity(registry.torch_dtype(dtype))
            assert float(got) == float(want)
    assert registry.accum_dtype(torch.bfloat16) == torch.float32
    assert registry.accum_dtype(torch.int32) == torch.int32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
def test_oracle_and_verify_agree(numpy_oracle, method, dtype):
    n = 70_001
    want = jax_oracle.host_reduce(jax_host_data(n, dtype, seed=3), method)
    got = oracle.host_reduce(host_data(n, dtype, seed=3), method)
    assert np.asarray(got).astype(np.float64) == \
        np.asarray(want).astype(np.float64)
    for dev in (got, np.float64(got) + 1e-3, np.float64(got) * 2 + 1):
        assert oracle.verify(dev, got, method, dtype, n) == \
            jax_oracle.verify(dev, got, method, dtype, n)


def test_output_rows_byte_identical():
    for status in QAStatus:
        outs = []
        for qa in (jax_qa, port_qa):
            buf = io.StringIO()
            qa.qa_start("tpu_reductions_torch", ["--method=SUM", "--n=8"],
                        out=buf)
            qa.qa_start("tpu_reductions_torch", None, out=buf)
            assert qa.qa_finish("tpu_reductions_torch",
                                qa.QAStatus(int(status)), out=buf) == status
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
    for args in ((826.0039, 8.1e-05, 1 << 24), (0.0, 0.0, 1),
                 (12345.678901, 1.23456789, 1 << 30)):
        assert port_logging.throughput_line(*args, workgroup=16) == \
            jax_logging.throughput_line(*args, workgroup=16)


CASES = [  # (method, dtype, kernel, cpu_final)
    ("SUM", "int32", 6, False), ("MIN", "int32", 6, False),
    ("SUM", "float32", 6, False), ("MAX", "float64", 6, False),
    ("SUM", "bfloat16", 6, False), ("SUM", "int32", 7, False),
    ("MAX", "int32", 7, False), ("SUM", "float64", 7, False),
    ("MIN", "int32", 7, True), ("SUM", "int32", 8, False),
    ("MAX", "bfloat16", 8, False), ("SUM", "float32", 9, False),
    ("SUM", "bfloat16", 9, False)]


def _assert_run_matches_jax(method, dtype, kernel, cpu_final=False,
                            stream_buffers=4):
    fields = dict(method=method, dtype=dtype, n=65536 + 5, threads=16,
                  max_blocks=8, kernel=kernel, cpu_final=cpu_final,
                  stream_buffers=stream_buffers, iterations=2,
                  log_file=None)
    port = driver.run_benchmark(
        ReduceConfig(platform="cpu", **fields),
        logger=port_logging.BenchLogger(console=io.StringIO()))
    jax_res = jax_driver.run_benchmark(
        JaxConfig(**fields),
        logger=jax_logging.BenchLogger(console=io.StringIO()))
    x = jax_oracle.native_fill(fields["n"], dtype)   # the JAX driver's
    if x is None:
        x = jax_host_data(fields["n"], dtype)
    want = float(np.asarray(pallas_reduce(
        jnp.asarray(x), method,
        threads=16, max_blocks=8, kernel=kernel, cpu_final=cpu_final,
        stream_buffers=stream_buffers, interpret=True), dtype=np.float64))
    tol = registry.tolerance(method, dtype, fields["n"])
    assert abs(port.device_result - want) <= tol
    if tol == 0.0:
        assert port.device_result == want == jax_res.device_result
    assert port.oracle_result == jax_res.oracle_result
    assert port.status == jax_res.status == QAStatus.PASSED
    assert (port.n, port.kernel, port.iterations) == \
        (jax_res.n, jax_res.kernel, jax_res.iterations)


ROUTED_CASES = [  # numpy keeps the ids the cases had before native ones
    pytest.param(route, *case, id="-".join(
        ([route] if route == "native" else []) + [str(v) for v in case]))
    for route in ("numpy", "native") for case in CASES]


@pytest.mark.parametrize("route, method, dtype, kernel, cpu_final",
                         ROUTED_CASES)
def test_run_benchmark_matches_jax(monkeypatch, route, method, dtype,
                                   kernel, cpu_final):
    """Both drivers on the same payload route give the same device value,
    oracle value and verdict."""
    use_route(monkeypatch, route)
    _assert_run_matches_jax(method, dtype, kernel, cpu_final)


@pytest.mark.parametrize("stream_buffers", [2, 8])
@pytest.mark.parametrize("method, dtype", [("SUM", "int32"),
                                           ("MIN", "float32")])
def test_stream_run_matches_jax(numpy_oracle, method, dtype,
                                stream_buffers):
    """k10 through both drivers, at a shallow and a deep pipeline."""
    _assert_run_matches_jax(method, dtype, 10, stream_buffers=stream_buffers)


def _run_cli(*args, tmp_path):
    log = tmp_path / "r.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch", *args,
         f"--logfile={log}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    return proc, log


def test_cli_passes(tmp_path):
    proc, log = _run_cli("--method=SUM", "--type=int", "--n=65536",
                         "--platform=cpu", tmp_path=tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("&&&& RUNNING tpu_reductions_torch ")
    assert lines[-1] == "&&&& tpu_reductions_torch PASSED"
    row = [ln for ln in lines if ln.startswith("Reduction, Throughput = ")]
    assert len(row) == 1 and "Size = 65536 Elements" in row[0]
    assert row[0] in log.read_text().splitlines()


def test_cli_waives_emptied_kernel(tmp_path):
    proc, _ = _run_cli("--method=MIN", "--type=float", "--n=4096",
                       "--platform=cpu", "--kernel=3", tmp_path=tmp_path)
    assert proc.returncode == 2
    assert proc.stdout.splitlines()[-1] == "&&&& tpu_reductions_torch WAIVED"


@pytest.mark.parametrize("kernel", [8, 9, 10])
def test_kernels_8_to_10_run(kernel, tmp_path):
    """The parser takes --kernel=8|9|10 (and k10's --streambuffers), the
    one-shot entry point reduces with it, and the CLI PASSES."""
    cfg, _ = parse_single_chip(["--method=SUM", f"--kernel={kernel}",
                                "--type=float", "--streambuffers=2",
                                "--platform=cpu"])
    assert (cfg.kernel, cfg.stream_buffers) == (kernel, 2)
    x = torch.arange(1000, dtype=torch.float32)
    assert kr.kernel_reduce(x, "SUM", kernel=kernel, threads=16,
                            device="cpu").item() == 499500.0
    proc, _ = _run_cli("--method=SUM", "--type=float", "--n=4096",
                       "--platform=cpu", f"--kernel={kernel}",
                       tmp_path=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "&&&& tpu_reductions_torch PASSED"


def test_cli_waives_k9_off_float_sum_and_kernel_11(tmp_path):
    """k9 is SUM over float dtypes only, as in the JAX driver, and kernel
    11 is not live; both WAIVE with exit 2. --streambuffers=0 is refused
    by the parser with exit 1, as the JAX CLI refuses it."""
    for args in (["--kernel=9", "--method=MIN", "--type=float"],
                 ["--kernel=9", "--method=SUM", "--type=int"],
                 ["--kernel=11", "--method=SUM", "--type=int"]):
        proc, _ = _run_cli(*args, "--n=4096", "--platform=cpu",
                           tmp_path=tmp_path)
        assert proc.returncode == 2, (args, proc.stderr)
        assert proc.stdout.splitlines()[-1] == \
            "&&&& tpu_reductions_torch WAIVED"
    res = driver.run_benchmark(
        ReduceConfig(method="MIN", dtype="float32", n=4096, kernel=9,
                     platform="cpu", log_file=None),
        logger=port_logging.BenchLogger(console=io.StringIO()))
    assert res.waived_reason == "kernel 9 (MXU) is SUM over float dtypes only"
    err = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(err):
        parse_single_chip(["--method=SUM", "--streambuffers=0",
                           "--platform=cpu"])
    # the JAX CLI lets ReduceConfig's ValueError escape: exit 1
    assert exc.value.code == 1 and "stream_buffers must be positive" in \
        err.getvalue()


@pytest.mark.parametrize("kernel", [6, 7, 8, 9, 10])
def test_chain_leaves_staged_tensor_unperturbed(kernel):
    n = 4096 + 7
    dtype = "float32" if kernel == 9 else "int32"   # k9 is float SUM only
    op, stage_fn, core = kr.make_staged_core("SUM", n, dtype, threads=8,
                                             max_blocks=4, kernel=kernel,
                                             device=torch.device("cpu"))
    x2d = stage_fn(host_data(n, dtype))
    before = x2d.clone()
    chained = chain.make_chained_reduce(core, op)
    once = core(x2d)
    assert chained(x2d, 1).item() == once.item()
    # each step folds the previous sum into x[0, 0]: the chain really
    # changes its own input, and only its own
    assert chained(x2d, 3).item() != once.item()
    assert torch.equal(x2d, before)


def test_chained_run_verifies_on_unperturbed_data(monkeypatch):
    """A chained SUM row must verify exactly: it would FAIL if the chain
    had folded its sums into the tensor the driver verifies."""
    real = driver.time_chained

    def positive_slope(*args, **kwargs):
        sw = real(*args, **kwargs)
        if sw.average_s <= 0:   # host noise at test scale
            sw = Stopwatch(total_s=1e-4, sessions=1, samples=[1e-4])
        return sw

    monkeypatch.setattr(driver, "time_chained", positive_slope)
    res = driver.run_benchmark(
        ReduceConfig(method="SUM", dtype="int32", n=65536, platform="cpu",
                     timing="chained", iterations=4, chain_reps=2,
                     log_file=None),
        logger=port_logging.BenchLogger(console=io.StringIO()))
    assert res.status == QAStatus.PASSED
    assert res.timing == "chained" and len(res.slope_samples_s) == 2
    assert res.device_result == res.oracle_result


def test_timing_modes_and_resolved_timing():
    base = dict(method="MAX", dtype="float32", n=4096, platform="cpu",
                iterations=3, log_file=None)
    for timing in ("periter", "bulk", "fetch"):
        res = driver.run_benchmark(
            ReduceConfig(timing=timing, **base),
            logger=port_logging.BenchLogger(console=io.StringIO()))
        assert res.status == QAStatus.PASSED and res.timing == timing
    assert driver.resolved_timing(
        ReduceConfig(timing="chained", cpu_final=True, **base)) == "fetch"
    assert driver.resolved_timing(ReduceConfig(timing="chained", **base)) \
        == "chained"


def test_batch_contains_a_crash(monkeypatch):
    real = driver._make_device_fn

    def crash_on_k7(cfg, backend, device):
        if cfg.kernel == 7:
            raise RuntimeError("injected")
        return real(cfg, backend, device)

    monkeypatch.setattr(driver, "_make_device_fn", crash_on_k7)
    cfg = ReduceConfig(method="SUM", dtype="int32", n=4096, platform="cpu",
                       iterations=2, log_file=None)
    seen = []
    results = driver.run_benchmark_batch(
        [cfg, dataclasses.replace(cfg, kernel=7), cfg],
        logger=port_logging.BenchLogger(console=io.StringIO()),
        on_result=lambda c, r: seen.append(r.status))
    assert [r.status for r in results] == seen == [
        QAStatus.PASSED, QAStatus.FAILED, QAStatus.PASSED]
    assert results[1].waived_reason == "RuntimeError: injected"
    assert results[1].to_dict()["device_result"] is None


def test_missing_device_index_waives():
    res = driver.run_benchmark(
        ReduceConfig(platform="cpu", device=1, n=4096, log_file=None),
        logger=port_logging.BenchLogger(console=io.StringIO()))
    assert res.status == QAStatus.WAIVED
    assert res.waived_reason == "device 1 not present (1 found)"
