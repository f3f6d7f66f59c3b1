"""The port's firstrow CLI (bench/firstrow.py, bench/headline.py) held
against the JAX package's on the CPU at small n: the same row status, row
and artifact keys, stage order and exit codes; nothing written outside
`--out` and the two files beside it (never the repository root's TPU
artifacts); the doubles through the pair route at the flagship grid's
span unless asked; a crash contained to a FAILED row; FIRSTROW_T0 as the
timeline's origin; an interrupted artifact's verified row reused. Chained
slopes are fixed at 1 ms on both sides (torch_routes).
"""

import importlib
import json
from pathlib import Path

import pytest

import tpu_reductions.bench.firstrow as jax_firstrow
import tpu_reductions_torch.bench.firstrow as firstrow_mod
from tpu_reductions_torch.bench import driver, headline
from torch_routes import fixed_slopes  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ROOT_ARTIFACTS = ("BENCH_snapshot.json", "BENCH_doubles.json")
ARGV = ["--n=65536", "--iterations=8", "--chainreps=2", "--doubles-n=16384",
        "--doubles-reps=2"]


def _root_state() -> dict:
    return {name: (REPO / name).read_bytes() if (REPO / name).exists()
            else None for name in ROOT_ARTIFACTS}


def _run(tmp_path, *extra) -> tuple:
    out = tmp_path / "fr" / "FIRSTROW.json"
    rc = firstrow_mod.main(ARGV + ["--platform=cpu", f"--out={out}",
                                   *extra])
    return rc, out


def test_firstrow_matches_jax(tmp_path, monkeypatch, fixed_slopes):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    root = _root_state()
    rc, out = _run(tmp_path)
    # nothing but --out and the doubles beside it; no root artifact
    assert sorted(p.name for p in out.parent.iterdir()) == [
        "FIRSTROW.json", "FIRSTROW.json.doubles.json"]
    assert list(cwd.iterdir()) == []
    assert _root_state() == root
    jax_out = tmp_path / "jax" / "FIRSTROW.json"
    jax_out.parent.mkdir()
    jax_rc = jax_firstrow.main(ARGV + ["--platform=cpu", f"--out={jax_out}"])
    assert rc == jax_rc == 0
    data, ref = json.loads(out.read_text()), json.loads(jax_out.read_text())
    assert set(data) == set(ref)
    assert set(data["row"]) == set(ref["row"])
    for key in ("method", "dtype", "n", "status", "timing", "iterations"):
        assert data["row"][key] == ref["row"][key], key
    assert data["row"]["status"] == "PASSED" and data["complete"] is True
    doubles = json.loads(Path(f"{out}.doubles.json").read_text())
    ref_doubles = json.loads(Path(f"{jax_out}.doubles.json").read_text())
    assert [(r["method"], r["status"]) for r in doubles["rows"]] == \
        [(r["method"], r["status"]) for r in ref_doubles["rows"]] == \
        [("SUM", "PASSED"), ("MIN", "PASSED"), ("MAX", "PASSED")]
    assert doubles["f64"] == "dd" and doubles["complete"] is True


def test_timeline_is_in_value_order(tmp_path, fixed_slopes):
    rc, out = _run(tmp_path)
    assert rc == 0
    labels = [m["label"] for m in json.loads(out.read_text())["timeline"]]
    order = ["process start", "torch ready", "int row done",
             "int row persisted", "f64 scoreboard", "firstrow complete"]
    at = [next(i for i, label in enumerate(labels) if label.startswith(o))
          for o in order]
    assert at == sorted(at) and labels[-1] == "firstrow complete"


def test_snapshot_only_on_the_flagship_geometry(tmp_path, monkeypatch,
                                               fixed_slopes):
    assert not headline.on_flagship_geometry(1 << 24, "cpu")
    assert not headline.on_flagship_geometry(65536, "gpu")
    monkeypatch.setattr(headline, "on_flagship_geometry",
                        lambda n, platform: True)
    rc, out = _run(tmp_path, "--skip-doubles")
    assert rc == 0
    snap = json.loads(Path(f"{out}.snapshot.json").read_text())
    assert snap["partial"] is True and snap["device"] == "cpu"
    assert list(snap["provenance"]["candidates"]) == ["cuda k6 threads=2048"]
    assert sorted(p.name for p in out.parent.iterdir()) == [
        "FIRSTROW.json", "FIRSTROW.json.snapshot.json"]


def test_doubles_span_is_not_the_int_rows(tmp_path, monkeypatch,
                                          fixed_slopes):
    seen = []
    monkeypatch.setattr(headline, "double_spots",
                        lambda path, **kw: seen.append(kw))
    assert _run(tmp_path)[0] == 0
    assert seen[-1]["iterations"] is None     # the flagship grid's
    assert _run(tmp_path, "--doubles-iterations=16")[0] == 0
    assert seen[-1]["iterations"] == 16


def test_a_crash_leaves_a_failed_row(tmp_path, monkeypatch):
    def boom(cfg, logger=None, **kw):
        raise RuntimeError("synthetic launch failure")

    monkeypatch.setattr(driver, "run_benchmark", boom)
    rc, out = _run(tmp_path, "--skip-doubles")
    assert rc == 1
    data = json.loads(out.read_text())
    assert data["row"]["status"] == "FAILED" and data["complete"] is True
    assert any("int row done" in m["label"] for m in data["timeline"])


def test_a_failed_doubles_run_is_not_fatal(tmp_path, monkeypatch, capsys,
                                           fixed_slopes):
    def boom(path, **kw):
        raise RuntimeError("synthetic doubles failure")

    monkeypatch.setattr(headline, "double_spots", boom)
    rc, _ = _run(tmp_path)
    assert rc == 0
    assert "doubles spot failed (non-fatal)" in capsys.readouterr().err


def test_session_t0_is_the_origin(tmp_path, monkeypatch, fixed_slopes):
    import time
    monkeypatch.setenv("FIRSTROW_T0", str(time.time() - 100.0))
    importlib.reload(firstrow_mod)
    try:
        rc, out = _run(tmp_path, "--skip-doubles")
        assert rc == 0
        timeline = json.loads(out.read_text())["timeline"]
        assert timeline[0]["t_rel_s"] >= 100.0
    finally:
        monkeypatch.delenv("FIRSTROW_T0")
        importlib.reload(firstrow_mod)


def test_an_interrupted_row_is_reused(tmp_path, monkeypatch, fixed_slopes):
    rc, out = _run(tmp_path, "--skip-doubles")
    assert rc == 0
    data = json.loads(out.read_text())
    data["complete"] = False
    out.write_text(json.dumps(data))
    calls = []
    monkeypatch.setattr(driver, "run_benchmark",
                        lambda cfg, **kw: calls.append(cfg))
    rc, out = _run(tmp_path, "--skip-doubles")
    assert rc == 0 and calls == []
    again = json.loads(out.read_text())
    assert again["row"] == data["row"]
    assert any("resumed" in m["label"] for m in again["timeline"])


def test_firstrow_refuses_a_bad_n():
    with pytest.raises(SystemExit) as exc:
        firstrow_mod.main(["--n=0", "--platform=cpu"])
    assert exc.value.code == 2
