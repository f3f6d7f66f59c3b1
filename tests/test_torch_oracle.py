"""The port's native oracle and filler (tpu_reductions_torch/csrc/oracle.cpp,
ops/_native.py, ops/oracle.py) held against the JAX package's
(csrc/oracle.cpp, tpu_reductions/ops/oracle.py), on the CPU.

Both libraries are built here by g++ from the same code, so with both
packages native the filler must give the same bits and the oracle the same
values, with no tolerance: int32/float32/float64 fills at several sizes,
ranks and seeds; host_reduce on all 9 op x dtype pairs, the threaded Kahan
sum from 2^22 elements included; IncrementalOracle chunk by chunk. Then the
library's build (concurrent builds, rebuild when stale, a failing compile)
and the routes: TPU_REDUCTIONS_NO_NATIVE and a failed build both give the
numpy route.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_reductions.ops import oracle as jax_oracle
from tpu_reductions.ops import stream as jax_stream
from tpu_reductions.utils.rng import host_data as jax_host_data
from tpu_reductions_torch.ops import _native, oracle
from tpu_reductions_torch.ops.stream import iter_chunks, plan_chunks
from tpu_reductions_torch.utils.rng import host_data
from torch_routes import both_native  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
NATIVE_DTYPES = ("int32", "float32", "float64")
METHODS = ("SUM", "MIN", "MAX")


@pytest.mark.parametrize("dtype", NATIVE_DTYPES)
def test_native_fill_matches_jax(both_native, dtype):
    for n in (1, 1000, 4096 + 7, 65537):
        for rank, seed in ((0, 0), (1, 2), (3, 9)):
            got = oracle.native_fill(n, dtype, rank=rank, seed=seed)
            want = jax_oracle.native_fill(n, dtype, rank=rank, seed=seed)
            assert got.dtype == want.dtype and got.shape == (n,)
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8))
            assert torch.equal(oracle.payload(n, dtype, rank, seed),
                               torch.from_numpy(want))


def test_bfloat16_has_no_native_filler(both_native):
    assert oracle.native_fill(100, "bfloat16") is None
    assert jax_oracle.native_fill(100, "bfloat16") is None
    assert oracle.route("bfloat16") == "numpy"
    assert torch.equal(oracle.payload(100, "bfloat16").view(torch.int16),
                       host_data(100, "bfloat16").view(torch.int16))


@pytest.mark.parametrize("dtype", NATIVE_DTYPES)
@pytest.mark.parametrize("method", METHODS)
def test_host_reduce_matches_jax(both_native, method, dtype):
    """The same value and dtype on the native payload and on signed data,
    as a numpy array and as a tensor; for real SUM also at 2^22 + 5
    elements, where both run the threaded Kahan sum."""
    rng = np.random.default_rng(5)
    signed = (rng.integers(-2**31, 2**31, 70_001).astype(np.int32)
              if dtype == "int32"
              else rng.standard_normal(70_001).astype(dtype))
    payloads = [oracle.native_fill(70_001, dtype, seed=3), signed]
    if method == "SUM" and dtype != "int32":
        payloads.append(oracle.native_fill((1 << 22) + 5, dtype))
    for x in payloads:
        want = jax_oracle.host_reduce(x, method)
        for got in (oracle.host_reduce(x, method),
                    oracle.host_reduce(torch.from_numpy(x), method)):
            assert type(got) is type(want)
            assert got == want


@pytest.mark.parametrize("method, dtype", [
    ("SUM", "int32"), ("SUM", "float32"), ("SUM", "float64"),
    ("MIN", "int32"), ("MAX", "float32"), ("MIN", "float64")])
def test_incremental_oracle_matches_jax(both_native, method, dtype):
    """Chunk by chunk, value and state equal the JAX oracle's."""
    x = oracle.native_fill(30_011, dtype, seed=1)
    plan = plan_chunks(x.size, dtype, 8192)
    got = oracle.IncrementalOracle(method, dtype)
    want = jax_oracle.IncrementalOracle(method, dtype)
    for c, cj in zip(iter_chunks(torch.from_numpy(x), plan),
                     jax_stream.iter_chunks(x, plan)):
        got.update(c)
        want.update(cj)
        assert got.value() == want.value()
        assert got.state() == want.state()
    assert got.count == x.size and plan.num_chunks > 2
    if method != "SUM" or dtype == "int32":      # exact classes
        assert got.value() == oracle.host_reduce(x, method)


_BUILD_AND_SUM = (
    "import sys\n"
    "from pathlib import Path\n"
    "import numpy as np\n"
    "from tpu_reductions_torch.ops import _native\n"
    "lib = _native.load(Path(sys.argv[1]))\n"
    "x = np.arange(1000, dtype=np.int32)\n"
    "print(lib.oracle_sum_i32(x, x.size))\n")


def test_concurrent_builds_both_load_a_good_library(tmp_path):
    lib = tmp_path / "liboracle.so"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_SUM,
                               str(lib)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for proc in procs:
        out, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, err
        assert out.split() == ["499500"]
    assert [p.name for p in tmp_path.iterdir()] == ["liboracle.so"]


def test_rebuilds_when_the_source_is_newer(tmp_path):
    lib = _native.build(tmp_path / "liboracle.so")
    assert _native.build(lib) == lib
    old = _native.SOURCE.stat().st_mtime - 60
    os.utime(lib, (old, old))
    _native.build(lib)
    assert lib.stat().st_mtime >= _native.SOURCE.stat().st_mtime


def test_failed_compile_raises_and_leaves_no_file(tmp_path, monkeypatch):
    bad = tmp_path / "oracle.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        _native.build(tmp_path / "lib" / "liboracle.so")
    assert not any((tmp_path / "lib").iterdir())


def test_failed_build_takes_the_numpy_route(monkeypatch):
    """_load (uncached here) gives None when the build raises; with no
    library the payload and oracle are numpy's, as the JAX package's
    are without its library."""
    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(_native, "load", broken)
    assert oracle._load.__wrapped__() is None
    monkeypatch.setattr(oracle, "_load", lambda: None)
    monkeypatch.setattr(jax_oracle, "_load", lambda: None)
    assert not oracle.native_available() and oracle.route("int32") == "numpy"
    assert oracle.native_fill(10, "int32") is None
    for dtype in NATIVE_DTYPES:
        x = oracle.payload(70_001, dtype, seed=2)
        assert torch.equal(x, host_data(70_001, dtype, seed=2))
        for method in METHODS:
            assert oracle.host_reduce(x, method) == jax_oracle.host_reduce(
                jax_host_data(70_001, dtype, seed=2), method)


def test_no_native_env_turns_the_library_off(tmp_path):
    """TPU_REDUCTIONS_NO_NATIVE, read at the first load: no library, the
    numpy payload, and a CLI row verified on it."""
    code = ("import json, torch\n"
            "from tpu_reductions_torch.ops import oracle\n"
            "from tpu_reductions_torch.utils.rng import host_data\n"
            "print(json.dumps([oracle.native_available(),\n"
            "    oracle.native_fill(10, 'int32') is None,\n"
            "    torch.equal(oracle.payload(999, 'float32'),\n"
            "                host_data(999, 'float32'))]))\n")
    env = dict(os.environ, TPU_REDUCTIONS_NO_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == [False, True, True]
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch", "--method=SUM",
         "--n=65536", "--platform=cpu", f"--logfile={tmp_path / 'r.txt'}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "payload and oracle: numpy" in proc.stdout
    want = jax_oracle.host_reduce(jax_host_data(65536, "int32"), "SUM")
    assert f"CPU result = {float(want)!r}" in proc.stdout


def test_cli_verifies_the_native_payload(tmp_path):
    """Without the switch the CLI fills and verifies natively, the JAX
    CLI's payload and oracle value."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch", "--method=SUM",
         "--n=65536", "--platform=cpu", f"--logfile={tmp_path / 'r.txt'}"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items()
             if k != "TPU_REDUCTIONS_NO_NATIVE"})
    assert proc.returncode == 0, proc.stderr
    assert "payload and oracle: native" in proc.stdout
    want = oracle.host_reduce(oracle.native_fill(65536, "int32"), "SUM")
    assert f"CPU result = {float(want)!r}" in proc.stdout
