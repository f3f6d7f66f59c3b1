"""The port's spot CLI (bench/spot.py) held against the JAX package's on
the CPU, and the parsers of the five CLIs this slice adds (spot, smoke,
family_spot, firstrow, warm) walked flag by flag against theirs.

Rows are compared with both packages on the numpy payload and oracle and
with chained timing's slope fixed at 1 ms on both sides (torch_routes):
at these sizes the host's noise would decide between PASSED and WAIVED.
The deliberate differences of each parser are listed in DIFFERENT and
nowhere else.
"""

import argparse
import json
from unittest import mock

import pytest

from tpu_reductions.bench import family_spot as jax_family_spot
from tpu_reductions.bench import firstrow as jax_firstrow
from tpu_reductions.bench import smoke as jax_smoke
from tpu_reductions.bench import spot as jax_spot
from tpu_reductions.bench import warm as jax_warm
from tpu_reductions_torch.bench import driver, family_spot, firstrow, smoke
from tpu_reductions_torch.bench import spot, warm
from torch_routes import fixed_slopes, numpy_oracle  # noqa: F401

PLATFORM = "gpu|cpu (default gpu) against the JAX cpu|tpu (default None)"
# CLI: {flag: what differs, on purpose}
DIFFERENT = {
    "spot": {"--platform": PLATFORM,
             "--backend": "auto|cuda|torch against the JAX auto|pallas|xla",
             "--f64": "the port only: float64's native or pair route"},
    "smoke": {"--platform": PLATFORM},
    "family_spot": {"--platform": PLATFORM},
    "firstrow": {"--platform": PLATFORM,
                 "--out": "out/FIRSTROW.json against FIRSTROW.json in the "
                          "working directory"},
    "warm": {"--platform": PLATFORM,
             "--out": "out/compile_ledger.json against compile_ledger.json "
                      "(the JAX package's TPU artifact at the root)"},
}
CLIS = {"spot": (spot, jax_spot), "smoke": (smoke, jax_smoke),
        "family_spot": (family_spot, jax_family_spot),
        "firstrow": (firstrow, jax_firstrow), "warm": (warm, jax_warm)}


class _Parsed(Exception):
    pass


def _parser_of(main) -> argparse.ArgumentParser:
    """The parser a CLI's main() builds, caught at its parse_args."""
    caught = {}

    def catch(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch):
        with pytest.raises(_Parsed):
            main([])
    return caught["parser"]


def _flags(parser) -> dict:
    return {opt: action for action in parser._actions
            for opt in action.option_strings
            if opt.startswith("--") and opt != "--help"}


def _described(action) -> tuple:
    return (action.dest, action.default, action.type, action.choices,
            action.nargs, action.const, type(action).__name__)


WALK = [(cli, flag) for cli, (port, ref) in CLIS.items()
        for flag in sorted(set(_flags(_parser_of(port.main)))
                           | set(_flags(_parser_of(ref.main))))]


@pytest.mark.parametrize("cli, flag", WALK, ids=[f"{c}{f}" for c, f in WALK])
def test_flag_matches_the_reference(cli, flag):
    """Every flag of both parsers agrees in destination, default, type,
    choices and action, or DIFFERENT says why not."""
    port, ref = (_flags(_parser_of(m.main)).get(flag) for m in CLIS[cli])
    if flag in DIFFERENT[cli]:
        if port is not None and ref is not None:
            assert port.dest == ref.dest
            assert _described(port) != _described(ref), \
                f"{cli} {flag} is listed as different but agrees"
        return
    assert port is not None and ref is not None, (cli, flag)
    assert _described(port) == _described(ref)


def test_different_names_only_flags_that_exist():
    for cli, (port, ref) in CLIS.items():
        both = set(_flags(_parser_of(port.main))) | set(
            _flags(_parser_of(ref.main)))
        assert set(DIFFERENT[cli]) <= both, cli


# ------------------------------------------------------------------ spot

SPOT_ARGV = ["--n=16384", "--iterations=8", "--chainreps=2"]


@pytest.mark.parametrize("extra, jax_extra", [
    (["--type=int"], ["--type=int"]),
    (["--type=float", "--methods=MAX,SUM"], ["--type=float",
                                             "--methods=MAX,SUM"]),
    (["--type=int", "--backend=torch"], ["--type=int", "--backend=xla"]),
    (["--type=double", "--f64=dd"], ["--type=double"]),
])
def test_spot_cli_matches_jax(tmp_path, capsys, numpy_oracle, fixed_slopes,
                              extra, jax_extra):
    out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    rc = spot.main(SPOT_ARGV + extra + ["--platform=cpu", f"--out={out}"])
    jax_rc = jax_spot.main(SPOT_ARGV + jax_extra
                           + ["--platform=cpu", f"--out={jax_out}"])
    assert rc == jax_rc == 0
    data, ref = json.loads(out.read_text()), json.loads(jax_out.read_text())
    assert data["complete"] is ref["complete"] is True
    assert set(data) - {"f64"} == set(ref)
    for row, want in zip(data["rows"], ref["rows"]):
        assert set(row) == set(want)
        for key in ("method", "dtype", "n", "kernel", "status", "threads",
                    "max_blocks", "chain_reps", "timing", "iterations"):
            assert row[key] == want[key], key
        assert row["status"] == "PASSED"
        if extra[0] != "--type=float":
            assert row["device_result"] == want["device_result"]
    assert [r["method"] for r in data["rows"]] == \
        [r["method"] for r in ref["rows"]]
    assert "wrote" in capsys.readouterr().out


def test_spot_contains_a_crashing_method(monkeypatch, fixed_slopes):
    real = driver.run_benchmark

    def sabotaged(cfg, **kw):
        if cfg.method == "MIN":
            raise RuntimeError("synthetic launch failure")
        return real(cfg, **kw)

    monkeypatch.setattr(driver, "run_benchmark", sabotaged)
    base = spot.ReduceConfig(n=4096, iterations=8, timing="chained",
                             chain_reps=2, platform="cpu", log_file=None)
    rows = spot.run_spots(base, ["SUM", "MIN", "MAX"])
    by = {r["method"]: r for r in rows}
    assert by["MIN"]["status"] == "FAILED"
    assert "synthetic launch failure" in by["MIN"]["waived_reason"]
    assert by["SUM"]["status"] == by["MAX"]["status"] == "PASSED"


@pytest.mark.parametrize("statuses, rc", [
    (["WAIVED", "WAIVED", "WAIVED"], 0), (["PASSED", "WAIVED", "PASSED"], 0),
    (["PASSED", "WAIVED", "FAILED"], 1)])
def test_spot_exit_codes_match_jax(monkeypatch, statuses, rc):
    def fake(base, methods, logger=None, on_result=None, resume=None):
        rows = [{"method": m, "dtype": "float64", "n": 16384, "gbps": None,
                 "status": s} for m, s in zip(methods, statuses)]
        for r in rows:
            on_result(r)
        return rows

    argv = ["--type=double", "--n=16384", "--platform=cpu"]
    monkeypatch.setattr(spot, "run_spots", fake)
    monkeypatch.setattr(jax_spot, "run_spots", fake)
    assert spot.main(argv) == jax_spot.main(argv) == rc


@pytest.mark.parametrize("argv", [["--methods=SUM,NOPE"], ["--type=quad"],
                                  ["--n=0"]])
def test_spot_refusals_match_jax(argv):
    for main in (spot.main, jax_spot.main):
        with pytest.raises(SystemExit) as exc:
            main(argv + ["--platform=cpu"])
        assert exc.value.code == 2


def test_spot_resumes_an_interrupted_artifact(tmp_path, monkeypatch,
                                              fixed_slopes):
    out = tmp_path / "spot.json"
    argv = SPOT_ARGV + ["--platform=cpu", f"--out={out}"]
    assert spot.main(argv) == 0
    data = json.loads(out.read_text())
    data["complete"] = False
    data["rows"] = data["rows"][:2]          # cut after SUM and MIN
    out.write_text(json.dumps(data))
    kept = data["rows"]
    measured = []
    real = driver.run_benchmark
    monkeypatch.setattr(driver, "run_benchmark",
                        lambda cfg, **kw: measured.append(cfg.method)
                        or real(cfg, **kw))
    assert spot.main(argv) == 0
    assert measured == ["MAX"]
    again = json.loads(out.read_text())
    assert again["complete"] is True and again["rows"][:2] == kept
    # a finished artifact is measured afresh
    assert spot.main(argv) == 0
    assert measured == ["MAX", "SUM", "MIN", "MAX"]
