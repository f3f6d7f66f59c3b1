"""The port's smoke CLI (bench/smoke.py) held against the JAX package's,
on the CPU: the same cases in the same order, with the same surface ids,
statuses, manifest keys and exit codes; a crashing case contained to its
row; the n guard; resume of an interrupted manifest. Chained slopes are
fixed at 1 ms on both sides (torch_routes): at these sizes the host's
noise would decide between PASSED and WAIVED.
"""

import json

import pytest

from tpu_reductions.bench import smoke as jax_smoke
from tpu_reductions_torch.bench import driver, smoke
from torch_routes import fixed_slopes  # noqa: F401

N = 512 * 128 * 8          # the smallest n the CLIs take


def test_cases_are_the_jax_cases():
    assert smoke.CASES == jax_smoke.CASES
    assert smoke.FAMILY_CASES == jax_smoke.FAMILY_CASES


def test_run_smoke_matches_jax(fixed_slopes):
    seen = []
    rows = smoke.run_smoke(n=N, platform="cpu",
                           on_result=lambda r: seen.append(r["name"]))
    want = jax_smoke.run_smoke(n=N)
    assert [r["name"] for r in rows] == [r["name"] for r in want] == seen
    for row, ref in zip(rows, want):
        assert set(row) == set(ref)
        assert (row["surface"], row["status"], row["ok"], row["error"]) == \
            (ref["surface"], ref["status"], ref["ok"], ref["error"])
        assert row["status"] == "PASSED"


def test_dd_cases_take_the_pair_route(monkeypatch, fixed_slopes):
    """float64 runs natively by default: the dd cases ask for the pair
    route, or they would never launch the pair kernel."""
    seen = []
    real = driver.run_benchmark

    def spy(cfg, **kw):
        seen.append((cfg.dtype, cfg.f64, cfg.backend, cfg.kernel))
        return real(cfg, **kw)

    monkeypatch.setattr(driver, "run_benchmark", spy)
    smoke.run_smoke(n=N, platform="cpu")
    assert seen[-2:] == [("float64", "dd", "auto", 6)] * 2
    assert all(f64 == "native" and backend == "cuda"
               for _dt, f64, backend, _k in seen[:-2])


def test_a_crashing_case_is_contained(monkeypatch, fixed_slopes):
    real = driver.run_benchmark

    def sabotaged(cfg, **kw):
        if cfg.kernel == 9:
            raise RuntimeError("synthetic launch failure")
        return real(cfg, **kw)

    monkeypatch.setattr(driver, "run_benchmark", sabotaged)
    by = {r["name"]: r for r in smoke.run_smoke(n=N, platform="cpu")}
    assert not by["k9 mxu f32"]["ok"]
    assert by["k9 mxu f32"]["status"] == "FAILED"
    assert "synthetic launch failure" in by["k9 mxu f32"]["error"]
    assert by["k10 stream depth=4"]["ok"] and by["family argk"]["ok"]


def test_a_failing_family_case_fails_its_row(monkeypatch, fixed_slopes):
    monkeypatch.setattr(smoke, "_family_case",
                        lambda surface, n, device: surface != "seg/segsum")
    by = {r["name"]: r for r in smoke.run_smoke(n=N, platform="cpu")}
    assert by["family seg reduce"]["status"] == "FAILED"
    assert not by["family seg reduce"]["ok"]
    assert by["family argk"]["status"] == "PASSED"


def test_smoke_cli_writes_the_manifest(tmp_path, capsys, fixed_slopes):
    out, jax_out = tmp_path / "smoke.json", tmp_path / "jax.json"
    assert smoke.main([f"--n={N}", "--platform=cpu", f"--out={out}"]) == 0
    assert jax_smoke.main([f"--n={N}", f"--out={jax_out}"]) == 0
    data, ref = json.loads(out.read_text()), json.loads(jax_out.read_text())
    assert set(data) == set(ref) and data["complete"] is True
    assert [c["name"] for c in data["cases"]] == \
        [c["name"] for c in ref["cases"]]
    total = len(smoke.CASES) + len(smoke.FAMILY_CASES)
    assert f"{total}/{total} cases built and verified" in \
        capsys.readouterr().out


@pytest.mark.parametrize("ok, rc", [(0, 1), (1, 0)])
def test_smoke_exit_code_is_the_jax_rule(monkeypatch, ok, rc):
    """Exit 0 when at least one case verified, as the JAX CLI."""
    def fake(n, logger=None, on_result=None, resume=None, platform="gpu"):
        rows = [{"name": f"c{i}", "surface": "k6", "ok": i < ok,
                 "status": "PASSED" if i < ok else "FAILED",
                 "seconds": 0.0, "error": None} for i in range(3)]
        for r in rows:
            on_result(r)
        return rows

    monkeypatch.setattr(smoke, "run_smoke", fake)
    assert smoke.main([f"--n={N}", "--platform=cpu"]) == rc


def test_smoke_cli_refuses_too_small_n():
    for main in (smoke.main, jax_smoke.main):
        with pytest.raises(SystemExit) as exc:
            main(["--n=1024"])
        assert exc.value.code == 2


def test_smoke_resumes_an_interrupted_manifest(tmp_path, monkeypatch,
                                               fixed_slopes):
    out = tmp_path / "smoke.json"
    argv = [f"--n={N}", "--platform=cpu", f"--out={out}"]
    assert smoke.main(argv) == 0
    data = json.loads(out.read_text())
    data["complete"] = False
    data["cases"] = data["cases"][:5]
    out.write_text(json.dumps(data))
    measured = []
    real = driver.run_benchmark
    monkeypatch.setattr(driver, "run_benchmark",
                        lambda cfg, **kw: measured.append(cfg.kernel)
                        or real(cfg, **kw))
    assert smoke.main(argv) == 0
    # the sixth case on: k8's big tile and the two dd cases
    assert measured == [8, 6, 6]
    again = json.loads(out.read_text())
    assert again["cases"][:5] == data["cases"]
