"""The port's streaming pipeline (tpu_reductions_torch/ops/stream.py,
bench/stream.py, ops/oracle.IncrementalOracle, utils/staging.py) held
against the JAX package's, on the CPU.

The same payload streams through both at the same small chunk bound: both
packages' numpy MT19937 filler, or, in the native cases, both packages'
native filler (csrc/oracle.cpp). int32, MIN/MAX and the float64 pair
path must give the same value bit for bit: wrapping adds, selections and
the error-free pair folds do not depend on how XLA or torch orders a
reduction. float32/bfloat16 SUM fold a chunk with each framework's own
sum and are held to registry.tolerance.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_reductions.ops import oracle as jax_oracle
from tpu_reductions.ops import stream as jax_stream
from tpu_reductions.utils.rng import host_data as jax_host_data
from tpu_reductions_torch.bench import stream as stream_cli
from tpu_reductions_torch.bench.driver import main as driver_main
from tpu_reductions_torch.ops import oracle, registry
from tpu_reductions_torch.ops.stream import (StreamReducer, iter_chunks,
                                             partial_from_jsonable,
                                             partial_to_jsonable,
                                             plan_chunks, run_stream)
from tpu_reductions_torch.utils.rng import host_data
from tpu_reductions_torch.utils.staging import ChunkStager
from torch_routes import numpy_oracle, use_route  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
DTYPES = ("int32", "float32", "float64", "bfloat16")
METHODS = ("SUM", "MIN", "MAX")
CPU = torch.device("cpu")


def as_float(v) -> float:
    return float(np.asarray(v, np.float64))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_chunks_matches_jax(dtype):
    for n in (1, 4999, 10_000_000):
        for bound in (None, 4096, 65536, 1 << 20, 3 << 20):
            got = plan_chunks(n, dtype, bound)
            want = jax_stream.plan_chunks(n, dtype, bound)
            assert (got.chunk_elems, got.num_chunks, got.chunk_bytes) == \
                (want.chunk_elems, want.num_chunks, want.chunk_bytes)
            assert [got.chunk_span(i) for i in range(min(3, got.num_chunks))] \
                == [want.chunk_span(i)
                    for i in range(min(3, want.num_chunks))]
    with pytest.raises(ValueError):
        plan_chunks(0, dtype)


# numpy keeps the ids the cases had before native ones
ROUTED = [pytest.param(route, dtype, method, id="-".join(
    ([route] if route == "native" else []) + [dtype, method]))
    for route in ("numpy", "native") for dtype in DTYPES
    for method in METHODS]


@pytest.mark.parametrize("route, dtype, method", ROUTED)
def test_run_stream_matches_jax(monkeypatch, route, dtype, method):
    """Multi-chunk with a ragged tail, on the payload each package's CLI
    takes on the route: the value against the JAX stream's and against
    the one-shot oracle."""
    use_route(monkeypatch, route)
    n = 4999
    x = oracle.payload(n, dtype)
    x_jax = jax_oracle.native_fill(n, dtype)
    if x_jax is None:
        x_jax = jax_host_data(n, dtype)
    if dtype != "bfloat16":
        np.testing.assert_array_equal(x.numpy(), x_jax)
    got = run_stream(x, method, chunk_bytes=4096, sync_every=2, device=CPU)
    want = jax_stream.run_stream(x_jax, method, chunk_bytes=4096,
                                 sync_every=2)
    assert got.num_chunks == want.num_chunks > 2
    assert got.syncs == want.syncs and got.nbytes == want.nbytes
    tol = registry.tolerance(method, dtype, n)
    if tol == 0.0 or dtype == "float64":
        assert as_float(got.value) == as_float(want.value)
    else:
        assert abs(as_float(got.value) - as_float(want.value)) <= tol
    ok, diff = oracle.verify(got.value, oracle.host_reduce(x, method),
                             method, dtype, n)
    assert ok, diff


def test_f64_pairs_minmax_and_int32_wrap_match_jax():
    """MIN/MAX of signed f64 stream as exact key pairs; an int32 SUM that
    wraps several times mid-stream agrees with the JAX stream and the
    oracles."""
    x = np.random.default_rng(7).normal(scale=1e12, size=3000)
    for method, ref in (("MIN", x.min()), ("MAX", x.max())):
        got = run_stream(torch.from_numpy(x), method, chunk_bytes=4096,
                         device=CPU)
        assert as_float(got.value) == ref == as_float(
            jax_stream.run_stream(x, method, chunk_bytes=4096).value)
    w = np.full(20_000, 2**30 - 17, dtype=np.int32)
    got = run_stream(torch.from_numpy(w), "SUM", chunk_bytes=8192,
                     sync_every=4, device=CPU)
    assert int(got.value) == int(jax_stream.run_stream(
        w, "SUM", chunk_bytes=8192, sync_every=4).value) == int(
        oracle.host_reduce(torch.from_numpy(w), "SUM"))
    assert int(w.astype(np.int64).sum()) > 2**33     # it really wrapped


@pytest.mark.parametrize("method, dtype, values", [
    ("SUM", "int32", None), ("SUM", "float32", None),
    ("SUM", "float64", None), ("MIN", "bfloat16", None),
    ("MAX", "float64", None),
    ("SUM", "int32", np.full(20_000, 2**30 - 17, dtype=np.int32))])
def test_incremental_oracle_matches_jax(numpy_oracle, method, dtype, values):
    """Value and state after every chunk, wrap and Kahan pair across the
    boundaries included; a state revived from JSON goes on identically."""
    x = values if values is not None else jax_host_data(4999, dtype)
    xt = torch.from_numpy(x) if dtype != "bfloat16" else host_data(4999,
                                                                   dtype)
    plan = plan_chunks(len(xt), dtype, 4096)
    got = oracle.IncrementalOracle(method, dtype)
    want = jax_oracle.IncrementalOracle(method, dtype)
    for i, (c, cj) in enumerate(zip(iter_chunks(xt, plan),
                                    jax_stream.iter_chunks(x, plan))):
        got.update(c)
        want.update(cj)
        assert as_float(got.value()) == as_float(want.value())
        assert got.state() == want.state()
        if i == 1:
            revived = oracle.IncrementalOracle.from_state(
                json.loads(json.dumps(got.state())))
    for c in list(iter_chunks(xt, plan))[2:]:
        revived.update(c)
    assert as_float(revived.value()) == as_float(got.value())
    assert got.count == len(xt)


@pytest.mark.parametrize("dtype", ("int32", "float32", "float64",
                                   "bfloat16"))
def test_resume_from_checkpoint_is_byte_identical(dtype):
    n = 30_000
    x = host_data(n, dtype)
    method = "MAX" if dtype == "bfloat16" else "SUM"
    full = run_stream(x, method, chunk_bytes=8192, sync_every=3, device=CPU)
    caps = []
    run_stream(x, method, chunk_bytes=8192, sync_every=3, device=CPU,
               on_sync=lambda d, p: caps.append(
                   (d, json.loads(json.dumps(partial_to_jsonable(p))))))
    assert len(caps) >= 2
    done, spec = caps[0]
    resumed = run_stream(x, method, chunk_bytes=8192, sync_every=3,
                         start_chunk=done,
                         init_partial=partial_from_jsonable(spec),
                         device=CPU)
    assert as_float(resumed.value) == as_float(full.value)
    assert resumed.resumed_from == done


def test_reducer_holds_at_most_two_chunks():
    """Each chunk is staged once, in order, into slot index % 2: the loop
    holds chunk i (folding) and i + 1 (in flight), never more."""
    n = 50_000
    r = StreamReducer("SUM", "int32", n, chunk_bytes=4096, device=CPU)
    staged, folded = [], []
    real_stage, real_fold = r.stage, r.fold

    def counting(flat, index):
        staged.append(index)
        assert len(staged) - len(folded) <= 2     # resident chunks
        slot, planes = real_stage(flat, index)
        assert slot == index % 2
        return slot, planes

    def counting_fold(chunk):
        folded.append(chunk[0])
        real_fold(chunk)

    r.stage, r.fold = counting, counting_fold
    res = run_stream(host_data(n, "int32"), "SUM", reducer=r, sync_every=4)
    assert res.chunks_done == r.plan.num_chunks == len(staged)
    assert staged == list(range(r.plan.num_chunks))
    assert folded == [i % 2 for i in staged]
    assert r.slots == 2


def test_oversize_chunk_is_refused():
    stager = ChunkStager(CPU, 8, (torch.int32,), chunk_bytes=4096)
    with pytest.raises(ValueError, match="per-chunk bound"):
        stager.put_chunk_async(0, [torch.zeros((64, 128), dtype=torch.int32)])
    # padded up to whole (8, 128) blocks: under eight rows over is allowed
    (got,) = stager.put_chunk_async(
        0, [torch.ones((15, 128), dtype=torch.int32)])
    assert got.shape == (15, 128) and int(got.sum()) == 15 * 128


def _final(path):
    data = json.loads(Path(path).read_text())
    return data, next(r for r in data["rows"] if r.get("final"))


def test_stream_cli_writes_artifact_with_overlap(tmp_path, capsys):
    out = tmp_path / "stream.json"
    rc = stream_cli.main(["--method=SUM", "--type=int", "--n=65536",
                          "--chunk-bytes=16384", "--sync-every=2",
                          "--serial-baseline", "--platform=cpu",
                          f"--out={out}"])
    assert rc == 0
    data, final = _final(out)
    assert data["complete"] is True and data["mode"] == "stream"
    assert final["status"] == "PASSED" and final["max_resident_chunks"] == 2
    for k in ("gbps_sustained", "chunks_per_s", "stream_wall_s",
              "serial_wall_s", "overlap_efficiency"):
        assert isinstance(final[k], (int, float)), k
    assert final["result"] == final["oracle"]
    syncs = [r for r in data["rows"] if not r.get("final")]
    assert len(syncs) == 8
    assert all("partial" in r and "oracle" in r for r in syncs)
    assert "overlap x" in capsys.readouterr().out


def test_stream_cli_resumes_interrupted_artifact(tmp_path, monkeypatch):
    """A run cut after two chunks leaves an incomplete artifact; the next
    run folds only the remaining chunks, and its value is an uninterrupted
    run's."""
    import tpu_reductions_torch.ops.stream as stream_mod

    out = tmp_path / "stream.json"
    args = ["--method=SUM", "--type=int", "--n=65536",
            "--chunk-bytes=16384", "--sync-every=1", "--platform=cpu",
            f"--out={out}"]
    real_fold = stream_mod.StreamReducer.fold
    folds = []

    def dying_fold(self, staged):
        if len(folds) == 2:
            raise RuntimeError("interrupted")
        folds.append(1)
        real_fold(self, staged)

    monkeypatch.setattr(stream_mod.StreamReducer, "fold", dying_fold)
    with pytest.raises(RuntimeError, match="interrupted"):
        stream_cli.main(args)
    monkeypatch.setattr(stream_mod.StreamReducer, "fold", real_fold)
    interrupted = json.loads(out.read_text())
    assert interrupted["complete"] is False
    assert [r["chunks_done"] for r in interrupted["rows"]] == [1, 2]

    assert stream_cli.main(args) == 0
    _, final = _final(out)
    assert final["resumed_from"] == 2 and final["status"] == "PASSED"
    control = tmp_path / "control.json"
    assert stream_cli.main(args[:-1] + [f"--out={control}"]) == 0
    assert _final(control)[1]["result"] == final["result"]


@pytest.mark.parametrize("args", [
    ["--method=MIN", "--type=float", "--n=32768"],
    ["--method=SUM", "--type=double", "--n=40001"]])
def test_driver_stream_mode_passes(tmp_path, capsys, args):
    rc = driver_main(args + ["--stream", "--chunk-bytes=16384",
                             "--platform=cpu",
                             f"--logfile={tmp_path / 'r.txt'}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "&&&& tpu_reductions_torch PASSED"
    assert "Throughput =" in out and "streamed " in out


def test_stream_cli_as_a_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.bench.stream",
         "--method=MAX", "--type=double", "--n=20001",
         "--chunk-bytes=16384", "--platform=cpu",
         f"--out={tmp_path / 's.json'}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[PASSED]" in proc.stdout
