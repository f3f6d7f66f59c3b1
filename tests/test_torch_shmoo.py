"""The rest of the port's single-chip CLI held against the JAX package's,
on the CPU: the size sweep (`--shmoo`, bench/sweep.py), the consistency
gate (`--check`, utils/debug.consistency_check), the profiler capture
(`--trace`), and bounded staging (utils/staging.maybe_chunked_stage) with
its environment knobs.

Where the JAX package reaches a Pallas kernel it runs in interpret mode,
as its own tests run it. The sweep's cells are compared with both
packages on the numpy payload and oracle, and chained timing's slope is
replaced by a fixed positive one on both sides: at these sizes the host's
noise would decide between PASSED and WAIVED.
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_reductions import config as jax_config
from tpu_reductions.bench import sweep as jax_sweep
from tpu_reductions.config import ReduceConfig as JaxConfig
from tpu_reductions.ops import oracle as jax_oracle
from tpu_reductions.ops import stream as jax_stream
from tpu_reductions.utils import debug as jax_debug
from tpu_reductions.utils import logging as jax_logging
from tpu_reductions.utils import timing as jax_timing
from tpu_reductions_torch import config
from tpu_reductions_torch.bench import driver, sweep
from tpu_reductions_torch.config import ReduceConfig
from tpu_reductions_torch.ops import dd_reduce as dd
from tpu_reductions_torch.ops import kernel_reduce as kr
from tpu_reductions_torch.ops import oracle
from tpu_reductions_torch.ops.registry import get_op
from tpu_reductions_torch.ops.stream import plan_chunks
from tpu_reductions_torch.utils import debug
from tpu_reductions_torch.utils.logging import BenchLogger
from tpu_reductions_torch.utils.qa import QAStatus
from tpu_reductions_torch.utils.rng import host_data
from tpu_reductions_torch.utils.staging import (device_put_chunked,
                                                maybe_chunked_stage)
from tpu_reductions_torch.utils.timing import Stopwatch

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DTYPES = ("int32", "float32", "float64", "bfloat16")
KNOBS = ("TPU_REDUCTIONS_STAGE_CHUNK_BYTES",
         "TPU_REDUCTIONS_STAGE_THRESHOLD_BYTES")


def _logger() -> BenchLogger:
    return BenchLogger(console=io.StringIO())


def _fixed_slope(chained, x, k_lo, k_hi, reps=5):
    """time_chained's stand-in: the chain runs once, the slope is 1 ms."""
    chained(x, k_lo)
    return Stopwatch(total_s=1e-3, sessions=1, samples=[1e-3])


@pytest.fixture
def numpy_route(monkeypatch):
    monkeypatch.setattr(jax_oracle, "_load", lambda: None)
    monkeypatch.setattr(oracle, "_load", lambda: None)


# ---------------------------------------------------------------------------
# --shmoo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("timing, iterations", [
    ("periter", None), ("periter", 2), ("chained", None), ("chained", 5),
    ("bulk", 20)])
def test_run_shmoo_matches_jax(numpy_route, monkeypatch, timing, iterations):
    """The same sizes, iteration counts (chained: spans), device values,
    oracle values and verdicts; iterations None is the default 100 with
    iterations_explicit off."""
    monkeypatch.setattr(driver, "time_chained", _fixed_slope)
    monkeypatch.setattr(jax_timing, "time_chained", _fixed_slope)
    fields = dict(method="SUM", dtype="int32", n=1, timing=timing,
                  chain_reps=2, log_file=None,
                  iterations=100 if iterations is None else iterations,
                  iterations_explicit=iterations is not None)
    seen = []
    port = sweep.run_shmoo(ReduceConfig(platform="cpu", **fields),
                           min_pow=10, max_pow=12, logger=_logger(),
                           on_result=lambda c, r: seen.append(c.n))
    ref = jax_sweep.run_shmoo(JaxConfig(**fields), min_pow=10, max_pow=12,
                              logger=jax_logging.BenchLogger(None, None))

    def cells(rows):
        return [(r.n, r.iterations, r.status.name, r.device_result,
                 r.oracle_result) for r in rows]

    assert cells(port) == cells(ref)
    assert [r.n for r in port] == seen == [1 << 10, 1 << 11, 1 << 12]
    assert all(r.passed for r in port)
    if timing == "chained":     # an explicit value bounds the span
        spans = [r.iterations for r in port]
        assert spans == [8] * 3 if iterations else min(spans) > 100


def test_chained_shmoo_skips_and_contains_a_crash(monkeypatch):
    """Chained cells run one at a time: skip_ns leaves sizes out,
    on_result fires per cell, and a cell that raises becomes a FAILED row
    while the others still run."""
    monkeypatch.setattr(driver, "time_chained", _fixed_slope)
    cfg = ReduceConfig(method="SUM", dtype="int32", n=1, timing="chained",
                       iterations=4, iterations_explicit=True,
                       platform="cpu", log_file=None)
    seen = []
    res = sweep.run_shmoo(cfg, min_pow=10, max_pow=12, skip_ns={1 << 11},
                          on_result=lambda c, r: seen.append(c.n),
                          logger=_logger())
    assert seen == [r.n for r in res] == [1 << 10, 1 << 12]
    real = sweep.run_benchmark

    def sabotage(c, **kw):
        if c.n == 1 << 11:
            raise RuntimeError("injected")
        return real(c, **kw)

    monkeypatch.setattr(sweep, "run_benchmark", sabotage)
    res = sweep.run_shmoo(cfg, min_pow=10, max_pow=12, logger=_logger())
    assert [r.status for r in res] == [QAStatus.PASSED, QAStatus.FAILED,
                                       QAStatus.PASSED]
    assert res[1].waived_reason == "RuntimeError: injected"


def test_cli_shmoo(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch", "--method=MAX",
         "--type=float", "--shmoo", "--shmoo-min=10", "--shmoo-max=12",
         "--platform=cpu", f"--logfile={tmp_path / 'r.txt'}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("shmoo MAX float32")]
    assert [r.split()[3] for r in rows] == ["n=1024", "n=2048", "n=4096"]
    assert all(r.endswith("[PASSED]") for r in rows)
    assert proc.stdout.splitlines()[-1] == "&&&& tpu_reductions_torch PASSED"


# ---------------------------------------------------------------------------
# --check
# ---------------------------------------------------------------------------

CHECKS = [  # (kernel, method, dtype, f64)
    (6, "SUM", "int32", "native"), (7, "MIN", "int32", "native"),
    (8, "MAX", "float32", "native"), (9, "SUM", "float32", "native"),
    (10, "SUM", "int32", "native"), (6, "SUM", "float64", "dd"),
    (6, "MAX", "float64", "dd")]


@pytest.mark.parametrize("kernel, method, dtype, f64", CHECKS)
def test_check_passes_and_matches_jax(kernel, method, dtype, f64):
    """--check is OK on k6-k10 and the f64 pair route, and its kernel and
    oracle values are the JAX check's on the same numpy payload."""
    n = 10_000
    rep = debug.consistency_check(method, dtype, n, threads=32, max_blocks=4,
                                  kernel=kernel, f64=f64, platform="cpu")
    assert rep.ok, rep.describe()
    assert rep.describe().startswith("[OK]")
    ref = jax_debug.consistency_check(method, dtype, n, threads=32,
                                      max_blocks=4, kernel=kernel)
    assert rep.oracle == ref.oracle
    if dtype == "int32" or method != "SUM":
        assert rep.kernel == rep.plain == ref.compiled == ref.interpreted
    res = driver.run_benchmark(
        ReduceConfig(method=method, dtype=dtype, n=n, kernel=kernel, f64=f64,
                     check=True, iterations=2, platform="cpu",
                     log_file=None), logger=_logger())
    assert res.status == QAStatus.PASSED


@pytest.mark.parametrize("side", ["plain", "comparator"])
def test_check_fails_its_row_when_a_side_is_perturbed(monkeypatch, side):
    real_plain = kr.single_pass_plain
    if side == "plain":
        monkeypatch.setattr(kr, "single_pass_plain",
                            lambda x2d, op: real_plain(x2d, get_op("MAX")))
    else:
        monkeypatch.setattr(debug, "make_torch_reduce",
                            lambda method: get_op("MIN").reduce)
    cfg = ReduceConfig(method="SUM", dtype="int32", n=4096, check=True,
                       iterations=2, platform="cpu", log_file=None)
    console = io.StringIO()
    res = driver.run_benchmark(cfg, logger=BenchLogger(console=console))
    assert res.status == QAStatus.FAILED
    assert res.waived_reason.startswith("consistency check: [MISMATCH]")
    assert "[MISMATCH] SUM/int32 n=4096" in console.getvalue()
    assert res.iterations == 0       # refused before anything was timed


@pytest.mark.parametrize("row", [
    dict(kernel=7, cpu_final=True, cpu_thresh=1),
    dict(kernel=7, cpu_final=False, cpu_thresh=8),
    dict(kernel=10, stream_buffers=2)])
def test_check_gates_the_rows_own_finish_and_depth(monkeypatch, row):
    """The gate runs the kernel at the row's --cpufinal, --cputhresh and
    --streambuffers, on the card's side and on the plain side."""
    seen = []
    real = debug.kernel_reduce

    def spy(x, method, **kwargs):
        seen.append(kwargs)
        return real(x, method, **kwargs)

    monkeypatch.setattr(debug, "kernel_reduce", spy)
    cfg = ReduceConfig(method="SUM", dtype="int32", n=4096, check=True,
                       iterations=2, platform="cpu", log_file=None, **row)
    res = driver.run_benchmark(cfg, logger=_logger())
    assert res.status == QAStatus.PASSED
    assert len(seen) == 2
    for kwargs in seen:
        for key in ("kernel", "cpu_final", "cpu_thresh", "stream_buffers"):
            assert kwargs[key] == getattr(cfg, key), key


def test_cli_check_exit_codes(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch", "--method=MIN",
         "--type=double", "--f64=dd", "--n=5000", "--check",
         "--platform=cpu", f"--logfile={tmp_path / 'r.txt'}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[OK] MIN/float64 n=5000" in proc.stdout


# ---------------------------------------------------------------------------
# --trace
# ---------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    trace_dir = tmp_path / "tr"
    res = driver.run_benchmark(
        ReduceConfig(method="SUM", dtype="int32", n=4096, iterations=2,
                     trace_dir=str(trace_dir), platform="cpu",
                     log_file=None), logger=_logger())
    assert res.status == QAStatus.PASSED
    events = json.loads((trace_dir / debug.TRACE_FILE).read_text())
    assert events["traceEvents"]
    got, device_events, launches = debug.trace_benchmark(
        lambda x: x * 2, torch.ones(16), trace_dir=str(tmp_path / "t2"),
        device=CPU, iterations=2)
    assert float(got[0]) == 2.0 and device_events == 0 and launches == 0
    assert (tmp_path / "t2" / "trace.json").exists()


def test_trace_missing_kernels_is_warned(monkeypatch, tmp_path):
    """A written trace with fewer device events than launches says so."""
    monkeypatch.setattr(driver, "trace_benchmark",
                        lambda fn, x, **kw: (fn(x), 1, 3))
    console = io.StringIO()
    res = driver.run_benchmark(
        ReduceConfig(method="SUM", dtype="int32", n=4096, iterations=2,
                     trace_dir=str(tmp_path), platform="cpu",
                     log_file=None), logger=BenchLogger(console=console))
    assert res.status == QAStatus.PASSED
    assert "WARNING: the trace" in console.getvalue()
    assert "1 device events for 3 launches" in console.getvalue()


# ---------------------------------------------------------------------------
# Bounded staging and its knobs
# ---------------------------------------------------------------------------


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_stage_is_bit_identical(monkeypatch, dtype):
    """Every chunk size, from one row to more than the payload, and ragged
    tails of every kind, give the one-shot stage's bits."""
    for n in (1, 127, 128, 129, 5000, 70_001):
        x = host_data(n, dtype, seed=n)
        for method in ("SUM", "MIN", "MAX"):
            op = get_op(method)
            tm, p, t = kr.choose_tiling(n, 16, 4, dtype)
            want = kr.stage_padded(x, tm, p, t, op, CPU)
            monkeypatch.setenv(KNOBS[1], "1")
            for chunk in (1, 512, 1000, 4096, 1 << 20):
                monkeypatch.setenv(KNOBS[0], str(chunk))
                got = maybe_chunked_stage(x, *want.shape,
                                          op.identity(x.dtype), CPU)
                assert _same_bits(got, want), (n, method, chunk)
            monkeypatch.delenv(KNOBS[1])
            monkeypatch.delenv(KNOBS[0])


def test_small_or_device_payloads_keep_the_one_shot_copy(monkeypatch):
    x = torch.arange(1000, dtype=torch.int32)
    assert maybe_chunked_stage(x, 8, 128, 0, CPU) is None
    monkeypatch.setenv(KNOBS[1], "4000")
    assert maybe_chunked_stage(x, 8, 128, 0, CPU) is None
    monkeypatch.setenv(KNOBS[1], "3999")
    assert maybe_chunked_stage(x, 8, 128, 0, CPU) is not None
    meta = torch.empty(1000, dtype=torch.int32, device="meta")
    assert maybe_chunked_stage(meta, 8, 128, 0, CPU) is None
    with pytest.raises(ValueError, match="payload 1000 > staged shape"):
        device_put_chunked(x, 7, 128, 0, CPU)


def test_env_knobs_stage_in_chunks(monkeypatch):
    """Under the knobs stage_padded and the f64 pair route's staging go in
    chunks with the one-shot bits, and a CLI row still PASSES with the
    same value."""
    n = 70_001
    wants = []
    for env in ({}, {KNOBS[0]: "4096", KNOBS[1]: "1"}):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert (config.stage_threshold_bytes() == 1) == bool(env)
        x = host_data(n, "float32")
        tm, p, t = kr.choose_tiling(n, 256, 64, "float32")
        stage, _, _ = dd.make_dd_device_reduce("MIN", n, device=CPU)
        res = driver.run_benchmark(
            ReduceConfig(method="SUM", dtype="int32", n=n, iterations=2,
                         platform="cpu", log_file=None), logger=_logger())
        wants.append((kr.stage_padded(x, tm, p, t, get_op("SUM"), CPU),
                      stage(host_data(n, "float64")), res))
    (a, (ahi, alo, _), ares), (b, (bhi, blo, _), bres) = wants
    assert _same_bits(a, b) and _same_bits(ahi, bhi) and _same_bits(alo, blo)
    assert ares.status == bres.status == QAStatus.PASSED
    assert ares.device_result == bres.device_result


ENV_VALUES = (None, "", "abc", "0", "-4096", "1e3", "4096", str(3 << 20))


@pytest.mark.parametrize("chunk_env", ENV_VALUES)
def test_env_knobs_parse_like_jax(monkeypatch, chunk_env):
    for threshold_env in ENV_VALUES:
        for name, value in zip(KNOBS, (chunk_env, threshold_env)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        for override in (None, 0, -1, 8192):
            assert config.stage_chunk_bytes(override) == \
                jax_config.stage_chunk_bytes(override)
            assert config.stage_threshold_bytes(override) == \
                jax_config.stage_threshold_bytes(override)
        # --stream's chunk default reads the knob as the JAX stream does
        for dtype in DTYPES:
            got = plan_chunks(10_000_000, dtype)
            want = jax_stream.plan_chunks(10_000_000, dtype)
            assert (got.chunk_elems, got.num_chunks, got.chunk_bytes) == \
                (want.chunk_elems, want.num_chunks, want.chunk_bytes)
