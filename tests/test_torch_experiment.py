"""The port's experiment sweep and pipeline held against the JAX
package's, on the CPU: `sweep_all` and `cell_matches` (bench/sweep.py),
`bench/experiment.py --dryrun` (the Python of
scripts/run_tpu_experiment.sh), and the offline tools that work on its
output directory, `bench/regen.py` and `bench/seed_cache.py`.

The JAX package's sweep runs its Pallas kernels in interpret mode, as its
own tests run them; the port's runs the kernels' plain versions
(--platform=cpu). Backend names map: the JAX package's "pallas" (its
kernels) is the port's "cuda", "xla" (its comparator) the port's "torch".
Chained timing's slope is replaced by a fixed 1 ms one where a test
compares verdicts or counts cells: at these sizes the host's noise would
decide between PASSED and WAIVED. Comparisons are exact.
"""

import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_reductions.bench import regen as jax_regen
from tpu_reductions.bench import seed_cache as jax_seed_cache
from tpu_reductions.bench import sweep as jax_sweep
from tpu_reductions.utils import logging as jax_logging
from tpu_reductions.utils import timing as jax_timing
from tpu_reductions_torch.bench import driver, experiment, regen
from tpu_reductions_torch.bench import seed_cache, sweep
from tpu_reductions_torch.utils.logging import BenchLogger
from tpu_reductions_torch.utils.timing import Stopwatch

REPO = Path(__file__).resolve().parents[1]
BACKENDS = {"cuda": "pallas", "torch": "xla"}   # port: JAX


def _logger() -> BenchLogger:
    return BenchLogger(console=io.StringIO())


def _fixed_slope(chained, x, k_lo, k_hi, reps=5):
    """time_chained's stand-in: the chain runs once, the slope is 1 ms."""
    chained(x, k_lo)
    return Stopwatch(total_s=1e-3, sessions=1, samples=[1e-3])


@pytest.fixture
def fixed_slope(monkeypatch):
    monkeypatch.setattr(driver, "time_chained", _fixed_slope)
    monkeypatch.setattr(jax_timing, "time_chained", _fixed_slope)


# ---------------------------------------------------------------------------
# sweep_all, cell_matches
# ---------------------------------------------------------------------------


def test_flagship_grid_is_the_jax_contract():
    """The same cells in the same order; the only change is the name of
    the kernel backend."""
    want = dict(jax_sweep.FLAGSHIP_GRID, backend="cuda")
    assert sweep.FLAGSHIP_GRID == want
    assert list(sweep.FLAGSHIP_GRID) == list(jax_sweep.FLAGSHIP_GRID)
    assert sweep.FLAGSHIP_GRID["dtypes"][0] == "float64"


@pytest.mark.parametrize("timing", ["periter", "chained"])
def test_sweep_all_matches_jax(tmp_path, fixed_slope, timing):
    """n = 2^12, 2 repeats, every op on int32 and float64: the same cache
    files, and per cell the same status, oracle value, repeat and keys."""
    kw = dict(methods=("SUM", "MIN", "MAX"), dtypes=("int32", "float64"),
              n=1 << 12, repeats=2, iterations=2, timing=timing,
              chain_reps=2, threads=256, kernel=6)
    port = sweep.sweep_all(**kw, backend="cuda", platform="cpu",
                           out_dir=str(tmp_path / "port"), logger=_logger())
    ref = jax_sweep.sweep_all(**kw, backend="pallas",
                              out_dir=str(tmp_path / "jax"),
                              logger=jax_logging.BenchLogger(None, None))

    def files(name):
        return sorted(p.name for p in
                      (tmp_path / name / "raw_output").glob("*.json"))

    assert files("port") == files("jax") and len(files("port")) == 12
    assert files("port")[0] == "run-float64-MAX-0.json"
    keys = ("method", "dtype", "n", "kernel", "status", "oracle_result",
            "repeat", "threads", "timing", "chain_reps", "iterations")
    for a, b in zip(port, ref):
        assert {k: a.get(k) for k in keys} == {k: b.get(k) for k in keys}
        assert BACKENDS[a["backend"]] == b["backend"]
        assert a["status"] == "PASSED"
    cached = json.loads((tmp_path / "port" / "raw_output"
                         / "run-int32-SUM-1.json").read_text())
    assert cached == port[[r["dtype"] for r in port].index("int32")
                          + 1]


def _sweep(tmp_path, **over):
    kw = dict(methods=("SUM",), dtypes=("int32",), n=4096, repeats=2,
              iterations=2, platform="cpu", out_dir=str(tmp_path),
              logger=_logger())
    kw.update(over)
    return sweep.sweep_all(**kw)


def test_sweep_all_resumes_cached_cells(tmp_path, monkeypatch):
    first = _sweep(tmp_path)
    assert len(list((tmp_path / "raw_output").glob("*.json"))) == 2
    monkeypatch.setattr(driver, "run_benchmark", None)   # nothing may run
    assert _sweep(tmp_path) == first


def test_sweep_all_without_resume_measures_again(tmp_path, monkeypatch):
    _sweep(tmp_path)
    real, runs = driver.run_benchmark, []
    monkeypatch.setattr(driver, "run_benchmark",
                        lambda cfg, **kw: runs.append(cfg.seed)
                        or real(cfg, **kw))
    rows = _sweep(tmp_path, resume=False)
    assert runs == [0, 1] and [r["repeat"] for r in rows] == [0, 1]


def test_sweep_resume_survives_truncated_raw_file(tmp_path):
    _sweep(tmp_path, repeats=1)
    raw, = (tmp_path / "raw_output").glob("*.json")
    raw.write_text('{"status": "PASSED", "n": 4096, "trunc')
    rows = _sweep(tmp_path, repeats=1)
    assert len(rows) == 1 and rows[0]["status"] == "PASSED"
    assert json.loads(raw.read_text()) == rows[0]


@pytest.mark.parametrize("first, second", [("torch", "cuda"),
                                           ("cuda", "torch")])
def test_sweep_resume_rejects_other_backend(tmp_path, first, second):
    assert _sweep(tmp_path, repeats=1, backend=first)[0]["backend"] == first
    assert _sweep(tmp_path, repeats=1, backend=second)[0]["backend"] \
        == second


def test_sweep_all_resume_keyed_on_timing(tmp_path, fixed_slope):
    assert _sweep(tmp_path, repeats=1)[0]["timing"] == "periter"
    row = _sweep(tmp_path, repeats=1, timing="chained", chain_reps=2)[0]
    assert row["timing"] == "chained" and row["chain_reps"] == 2


def test_sweep_all_chained_caches_cells_before_a_late_crash(tmp_path,
                                                            fixed_slope,
                                                            monkeypatch):
    """Chained cells run one at a time: the cells before a crashing one
    are on disk when it crashes, the crash is a FAILED row, and a failed
    cell is never cached."""
    real = sweep.run_benchmark
    on_disk = []

    def sabotage(cfg, **kw):
        if cfg.method == "MAX":
            on_disk.append(len(list((tmp_path / "raw_output")
                                    .glob("*.json"))))
            raise RuntimeError("synthetic mid-grid death")
        return real(cfg, **kw)

    monkeypatch.setattr(sweep, "run_benchmark", sabotage)
    rows = _sweep(tmp_path, methods=("SUM", "MIN", "MAX"), repeats=1,
                  timing="chained", chain_reps=2)
    assert [r["status"] for r in rows] == ["PASSED", "PASSED", "FAILED"]
    assert on_disk == [2]
    assert not (tmp_path / "raw_output" / "run-int32-MAX-0.json").exists()


def _grid_row(backend, method="SUM", dtype="float64", gbps=150.0, **over):
    """A flagship-grid cell as sweep_all caches it."""
    g = jax_sweep.FLAGSHIP_GRID
    row = {"method": method, "dtype": dtype, "n": g["n"], "backend": backend,
           "kernel": g["kernel"], "gbps": gbps, "avg_s": 1e-3,
           "iterations": g["iterations"], "status": "PASSED",
           "device_result": 1.0, "oracle_result": 1.0, "abs_diff": 0.0,
           "waived_reason": None, "timing": g["timing"],
           "threads": g["threads"], "chain_reps": g["chain_reps"]}
    row.update(over)
    return row


CELL_VARIANTS = [{}, {"status": "FAILED"}, {"status": "WAIVED"},
                 {"chain_reps": 7}, {"threads": 384}, {"kernel": 7},
                 {"n": 1 << 20}, {"iterations": 128}, {"timing": "fetch"},
                 {"method": "MIN"}, {"dtype": "int32"}, {"other": True},
                 {"backend": "comparator"}]


@pytest.mark.parametrize("over", CELL_VARIANTS, ids=str)
@pytest.mark.parametrize("asked", ["cuda", "torch"])
def test_cell_matches_matches_jax(over, asked):
    """The same verdict on the same row, backend names mapped, for the
    flagship contract and a periter one."""
    for contract in (dict(jax_sweep.FLAGSHIP_GRID),
                     dict(jax_sweep.FLAGSHIP_GRID, timing="periter")):
        args = {k: contract[k] for k in ("n", "kernel", "threads",
                                         "iterations", "timing",
                                         "chain_reps")}
        rest = {k: v for k, v in over.items() if k != "backend"}
        for row_backend in ("cuda", "torch"):
            port = sweep.cell_matches(
                _grid_row(over.get("backend", row_backend), **rest),
                method="SUM", dtype="float64", backend=asked, **args)
            ref = jax_sweep.cell_matches(
                _grid_row(over.get("backend", BACKENDS[row_backend]),
                          **rest),
                method="SUM", dtype="float64", backend=BACKENDS[asked],
                **args)
            assert port == ref


# ---------------------------------------------------------------------------
# experiment --dryrun
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
    """One `experiment OUT --dryrun` (main, the CLI's entry) with a fixed
    chained slope; yields (OUT, its exit code, its stdout)."""
    out = tmp_path_factory.mktemp("experiment") / "out"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "time_chained", _fixed_slope)
        buf = io.StringIO()
        mp.setattr(sys, "stdout", buf)
        rc = experiment.main([str(out), "--dryrun"])
    yield out, rc, buf.getvalue()


def test_dryrun_writes_every_artifact(dryrun_dir):
    out, rc, text = dryrun_dir
    assert rc == 0
    raw = sorted(p.name for p in
                 (out / "single_chip" / "raw_output").glob("run-*.json"))
    assert raw == sorted(f"run-{d}-{m}-{r}.json"
                         for d in ("float64", "int32")
                         for m in ("SUM", "MIN", "MAX") for r in (0, 1))
    cells = [json.loads((out / "single_chip" / "raw_output" / f)
                        .read_text()) for f in raw]
    assert {(c["n"], c["status"], c["threads"], c["backend"], c["timing"])
            for c in cells} == {(1 << 18, "PASSED", 512, "cuda", "chained")}
    avgs = json.loads((out / "single_chip" / "averages.json").read_text())
    assert sorted(avgs) == ["DOUBLE MAX", "DOUBLE MIN", "DOUBLE SUM",
                            "INT MAX", "INT MIN", "INT SUM"]
    rows = json.loads((out / "shmoo.json").read_text())
    assert [(r["dtype"], r["n"]) for r in rows] == (
        [("bfloat16", 1 << p) for p in range(10, 15)]
        + [("float64", 1 << p) for p in range(10, 14)]
        + [("int32", 1 << p) for p in range(10, 15)])
    assert {r["status"] for r in rows} == {"PASSED"}
    ann = json.loads((out / "roofline.json").read_text())
    assert [r["n"] for r in ann] == [r["n"] for r in rows]
    assert {r["device_kind"] for r in ann} == {"cpu"}
    for name in ("report.md", "report.tex", "bandwidth_vs_n.png",
                 "bandwidth_vs_n.eps", "writeup.pdf", "device.txt"):
        assert (out / name).stat().st_size > 0, name
    md = (out / "report.md").read_text()
    assert "Device: cpu (--dryrun" in md
    assert "| INT | SUM | 90.8413 |" in md and "## Roofline" in md
    assert "experiment host seconds: grid" in text


def test_dryrun_again_measures_nothing(dryrun_dir, tmp_path, monkeypatch):
    """A second run over the same directory resumes every grid cell and
    every curve cell, and rewrites the report from them."""
    out = tmp_path / "out"
    shutil.copytree(dryrun_dir[0], out)
    (out / "report.md").unlink()
    monkeypatch.setattr(sweep, "run_benchmark", None)
    monkeypatch.setattr(driver, "run_benchmark", None)
    res = experiment.run_experiment(out, dryrun=True, logger=_logger())
    assert res["curve_results"] == [] and len(res["grid"]) == 12
    assert (out / "shmoo.json").read_text() == \
        (dryrun_dir[0] / "shmoo.json").read_text()
    assert (out / "report.md").exists()


def test_experiment_refuses_another_devices_directory(dryrun_dir, tmp_path,
                                                     monkeypatch):
    """The cached cells do not name their device: a directory of the dry
    run's CPU cells is refused on another device, not resumed."""
    out = tmp_path / "out"
    shutil.copytree(dryrun_dir[0], out)
    monkeypatch.setattr(experiment, "device_line",
                        lambda dryrun: "NVIDIA H100 80GB HBM3, 700.00 W")
    with pytest.raises(RuntimeError, match="holds cells measured on cpu"):
        experiment.run_experiment(out, dryrun=True, logger=_logger())
    assert (out / "device.txt").read_text().startswith("cpu")


def test_curve_configurations_match_the_jax_scripts():
    """bf16 to 2^30, f64 to 2^28, int32 to 2^29 and the 2^30 cell last
    (the dry run: 2^14, 2^13, 2^14); chained SUM through kernel 6."""
    assert experiment.CURVES == (("bfloat16", 30), ("float64", 28),
                                 ("int32", 29))
    assert experiment.HAZARD_POW == 30
    cfg = experiment.curve_cfg("int32", "cpu", dryrun=True)
    assert (cfg.method, cfg.kernel, cfg.threads, cfg.timing, cfg.chain_reps,
            cfg.stat, cfg.backend, cfg.iterations_explicit) == (
        "SUM", 6, 512, "chained", 2, "median", "cuda", False)
    assert experiment.curve_cfg("int32", "gpu", dryrun=False).chain_reps == 5


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")


def test_experiment_raises_without_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="--dryrun"):
        experiment.run_experiment(tmp_path / "out")
    assert not (tmp_path / "out").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.bench.experiment",
         str(tmp_path / "cli")], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "cli").exists()


# ---------------------------------------------------------------------------
# regen, seed_cache
# ---------------------------------------------------------------------------


def _spot(path, rows):
    path.write_text(json.dumps({"dtype": "DOUBLE", "n": 1 << 24,
                                "complete": True, "rows": rows}))
    return path


def test_seed_cache_matches_jax(tmp_path):
    """The same spot rows into the same grid dirs: the same cells written
    (live cells kept, stale ones replaced, non-contract and non-finite
    rows skipped, nothing seeded twice), equal files with backends
    mapped."""
    rows = {"jax": [], "port": []}
    for name, backend in (("port", "cuda"), ("jax", "pallas")):
        raw = tmp_path / name / "grid" / "raw_output"
        raw.mkdir(parents=True)
        (raw / "run-float64-SUM-0.json").write_text(json.dumps(
            _grid_row(backend, timing="fetch", gbps=0.87)))   # stale
        (raw / "run-float64-SUM-1.json").write_text(json.dumps(
            _grid_row(backend, gbps=140.0)))                  # live
        rows[name] = [_grid_row(backend, gbps=150.0),
                      _grid_row(backend, "MIN", gbps=151.0),
                      _grid_row(backend, "MAX", gbps=None),
                      _grid_row(backend, kernel=7),
                      _grid_row(backend, dtype="bfloat16")]
    port_spot = _spot(tmp_path / "port" / "spot.json", rows["port"])
    jax_spot = _spot(tmp_path / "jax" / "spot.json", rows["jax"])
    seeded = seed_cache.seed(port_spot, tmp_path / "port" / "grid",
                             log=lambda *a: None)
    ref = jax_seed_cache.seed(jax_spot, tmp_path / "jax" / "grid",
                              log=lambda *a: None)
    assert [p.name for p in seeded] == [p.name for p in ref] == [
        "run-float64-SUM-0.json", "run-float64-MIN-0.json"]
    for p, q in zip(seeded, ref):
        got, want = json.loads(p.read_text()), json.loads(q.read_text())
        assert BACKENDS[got.pop("backend")] == want.pop("backend")
        assert got == want and got["seeded_from"] == "spot.json"
    assert seed_cache.seed(port_spot, tmp_path / "port" / "grid",
                           log=lambda *a: None) == []
    assert seed_cache.main([str(tmp_path / "absent.json"), "--grid-dir",
                            str(tmp_path / "port" / "grid")]) == 0


def test_collect_averages_matches_jax(tmp_path):
    """Contract cells first; other disciplines at the flagship geometry
    only as the fallback; other tiles and backends never."""
    for name, backend in (("port", "cuda"), ("jax", "pallas")):
        raw = tmp_path / name / "raw_output"
        raw.mkdir(parents=True)
        cells = {"run-float64-SUM-0": _grid_row(backend, gbps=150.0),
                 "run-float64-SUM-1": _grid_row(backend, timing="fetch",
                                                gbps=0.87),
                 "run-float64-MIN-0": _grid_row(backend, "MIN",
                                                timing="fetch", gbps=0.89),
                 "run-float64-MAX-0": _grid_row(backend, "MAX",
                                                threads=1024, gbps=9999.0),
                 "run-int32-SUM-0": _grid_row(backend, "SUM", "int32",
                                              gbps=2300.0)}
        for f, row in cells.items():
            (raw / f"{f}.json").write_text(json.dumps(row))
    port = regen.collect_averages(tmp_path / "port", log=lambda *a: None)
    assert port == jax_regen.collect_averages(tmp_path / "jax",
                                              log=lambda *a: None)
    assert port == {("DOUBLE", "SUM"): 150.0, ("DOUBLE", "MIN"): 0.89,
                    ("INT", "SUM"): 2300.0}


def test_regenerate_the_dryrun_dir(dryrun_dir, tmp_path):
    """regen over the dry run's directory, with flagship cells seeded
    from a spot artifact and a stream probe beside it: averages.json from
    the contract cells, the roofline kept with its recorded kind, the
    report rewritten with the recorded device line and the probe's
    table, the figure and the PDF."""
    out = tmp_path / "out"
    shutil.copytree(dryrun_dir[0], out)
    for name in ("report.md", "report.tex", "writeup.pdf",
                 "bandwidth_vs_n.png", "roofline.json"):
        (out / name).unlink()
    (out / "roofline.json").write_text(
        (dryrun_dir[0] / "roofline.json").read_text())
    spot = _spot(tmp_path / "spot.json",
                 [_grid_row("cuda", gbps=2200.0),
                  _grid_row("cuda", "SUM", "int32", gbps=2400.0)])
    assert len(seed_cache.seed(spot, out / "single_chip",
                               log=lambda *a: None)) == 2
    (out / "stream_probe.json").write_text(json.dumps({
        "method": "SUM", "dtype": "int32", "n": 1 << 26, "complete": True,
        "rows": [{"final": True, "num_chunks": 16, "gbps_sustained": 19.8,
                  "chunks_per_s": 4.7, "overlap_efficiency": 1.5,
                  "status": "PASSED"}]}))
    logs = []
    assert regen.regenerate(out, log=logs.append) is True
    assert json.loads((out / "single_chip" / "averages.json").read_text()) \
        == {"DOUBLE SUM": 2200.0, "INT SUM": 2400.0}
    ann = json.loads((out / "roofline.json").read_text())
    assert {r["device_kind"] for r in ann} == {"cpu"}
    md = (out / "report.md").read_text()
    assert "Device: cpu (--dryrun" in md
    assert "| DOUBLE | SUM | 92.7729 | 2200.0000 | 23.71x |" in md
    assert "| stream_probe | SUM/int32 | 67108864 | 16 | 19.8 | 4.7 | x1.5 " \
        "| PASSED |" in md
    for name in ("report.tex", "writeup.pdf", "bandwidth_vs_n.png"):
        assert (out / name).exists(), name
    assert any("appended streaming-pipeline table" in m for m in logs)
    assert regen.regenerate(tmp_path / "nothing", log=logs.append) is False
