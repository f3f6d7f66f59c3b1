"""The port's warm CLI (bench/warm.py) on the CPU: the JAX registry's
surface ids (the comparator's `xla` is `torch` here; the serving bucket
waits for the serving engine), a manifest of the JAX artifact's shape and
rows' keys with one cold and one warm row per surface, resume of an
interrupted pass, a failed surface reported without stopping the pass,
the exit codes, and nothing written but `--out`. The build's rows need
nvcc and the card; here `ops/_cuda.build` is stood in for.
"""

import json

import pytest

from tpu_reductions.bench import warm as jax_warm
from tpu_reductions_torch.bench import warm
from tpu_reductions_torch.ops import _cuda

N = 512 * 128 * 8
FAST = "k6,k8,dd,torch,stream,xla-cumsum,argk/argmin"
# the keys of a JAX compile-ledger row (obs/compile.py: compile_span's
# row, less cache_new, plus the store's count)
JAX_ROW_KEYS = {"surface", "platform", "verdict", "dur_s", "lower_s",
                "compile_s", "count"}


def test_surfaces_are_the_jax_registrys():
    port = [s for s, _ in warm.surfaces()]
    jax = [s for s, _ in jax_warm.surfaces()]
    assert port == [("torch" if s == "xla" else s) for s in jax]


def test_warm_cli_writes_cold_and_warm_rows(tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = tmp_path / "w" / "compile_ledger.json"
    assert warm.main([f"--n={N}", "--platform=cpu", f"--only={FAST}",
                      f"--out={out}"]) == 0
    data = json.loads(out.read_text())
    assert set(data) == {"kind", "version", "complete", "surfaces"}
    assert (data["kind"], data["version"], data["complete"]) == \
        ("compile-observatory", 1, True)
    got = {(r["surface"], r["verdict"]) for r in data["surfaces"]}
    assert got == {(s, v) for s in FAST.split(",") for v in ("cold", "warm")}
    for row in data["surfaces"]:
        assert set(row) == JAX_ROW_KEYS
        assert row["platform"] == "cpu" and row["dur_s"] > 0
        assert row["count"] == 1
    assert list(cwd.iterdir()) == []
    assert [p.name for p in out.parent.iterdir()] == ["compile_ledger.json"]
    # a second pass over a complete artifact probes afresh
    assert warm.main([f"--n={N}", "--platform=cpu", "--only=k6",
                      f"--out={out}"]) == 0
    rows = json.loads(out.read_text())["surfaces"]
    assert {r["count"] for r in rows if r["surface"] == "k6"} == {2}


def test_warm_resumes_an_interrupted_pass(tmp_path, monkeypatch):
    out = tmp_path / "compile_ledger.json"
    banked = {"surface": "k6", "platform": "cpu", "verdict": "cold",
              "dur_s": 1.0, "lower_s": None, "compile_s": None, "count": 1}
    out.write_text(json.dumps({"kind": "compile-observatory", "version": 1,
                               "complete": False, "surfaces": [banked]}))
    assert warm.main([f"--n={N}", "--platform=cpu", "--only=k6,torch",
                      f"--out={out}"]) == 0
    rows = json.loads(out.read_text())["surfaces"]
    assert banked in rows                      # not probed again
    assert {(r["surface"], r["verdict"]) for r in rows} == {
        ("k6", "cold"), ("torch", "cold"), ("torch", "warm")}


def test_a_failed_surface_is_reported_and_the_pass_goes_on(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    def boom(n, device):
        raise RuntimeError("no build for you")

    monkeypatch.setattr(warm, "surfaces",
                        lambda: [("broken", boom), warm._torch_surface()])
    out = tmp_path / "compile_ledger.json"
    assert warm.main([f"--n={N}", "--platform=cpu", f"--out={out}"]) == 0
    assert {r["surface"] for r in json.loads(out.read_text())["surfaces"]} \
        == {"torch"}
    assert "FAILED: broken" in capsys.readouterr().out


def test_warm_exits_1_when_every_surface_failed(tmp_path, monkeypatch):
    def boom(n, device):
        raise RuntimeError("nope")

    monkeypatch.setattr(warm, "surfaces", lambda: [("broken", boom)])
    assert warm.main([f"--n={N}", "--platform=cpu",
                      f"--out={tmp_path / 'c.json'}"]) == 1


def test_build_rows_time_a_cold_then_a_warm_build(tmp_path, monkeypatch):
    dirs = []

    def fake_build(build_dir):
        dirs.append(build_dir)
        return (12.5 if len(dirs) == 1 else 0.01), ""

    monkeypatch.setattr(_cuda, "build", fake_build)
    rows = warm.build_rows(str(tmp_path), "gpu")
    assert dirs == [str(tmp_path)] * 2
    assert [(r["surface"], r["verdict"], r["compile_s"]) for r in rows] == [
        ("nvcc", "cold", 12.5), ("nvcc", "warm", 0.01)]


def test_warm_refuses_too_small_n():
    for main in (warm.main, jax_warm.main):
        with pytest.raises(SystemExit) as exc:
            main(["--n=1024", "--platform=cpu"])
        assert exc.value.code == 2
