"""The port's round metric (tpu_reductions_torch/bench/round.py) on the
CPU, against the JAX package's root bench.py: one JSON line on stdout with
bench.py's keys and metric text, vs_baseline = value / 90.8413 rounded to
4 places, the candidates' rows on stderr, exit 0 when a candidate PASSED,
and nothing written outside --out (off the card, nothing at all)."""

import importlib.util
import json
import types
from pathlib import Path

import pytest

from tpu_reductions_torch.bench import headline
from tpu_reductions_torch.bench import round as round_cli
from tpu_reductions_torch.utils.qa import QAStatus

REPO = Path(__file__).resolve().parents[1]
ARGV = ["--platform=cpu", "--n=65536", "--iterations=16"]


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", REPO / "bench.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_round_prints_one_line_with_bench_py_keys(in_tmp, capsys):
    rc = round_cli.main(ARGV + [f"--out={in_tmp / 'r'}"])
    captured = capsys.readouterr()
    assert rc == 0
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["unit"] == "GB/s" and line["value"] > 0
    assert line["metric"] == ("single-chip int32 SUM reduction bandwidth, "
                              "n=2^16")
    assert line["vs_baseline"] == round(line["value"] / 90.8413, 4)
    assert headline.BASELINE_GBPS == _load_bench().BASELINE_GBPS
    for backend, kernel, threads in headline.CANDIDATES:
        assert f"# {backend} k{kernel} threads={threads}: " in captured.err
    assert "# spread: " in captured.err
    # off the card nothing is written, --out included
    assert list(in_tmp.iterdir()) == []


def test_round_line_has_the_keys_of_bench_py(capsys):
    """The root bench.py's own line at the same size, for its keys and
    metric text."""
    bench = _load_bench()
    assert bench.main(["--n", "65536", "--iterations", "16",
                       "--platform", "cpu"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert round_cli.main(ARGV + ["--out=/nonexistent/never"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(ref)
    assert got["metric"] == ref["metric"]


def _result(gbps, status, samples=None):
    return types.SimpleNamespace(gbps=gbps, status=status,
                                 passed=status == QAStatus.PASSED,
                                 slope_samples_s=samples)


def test_payload_takes_the_best_passed_candidate():
    rows = [_result(10.0, QAStatus.PASSED), _result(99.0, QAStatus.FAILED),
            _result(12.34567, QAStatus.PASSED)]
    line = round_cli.payload(rows, 1 << 24)
    assert line == {"metric": "single-chip int32 SUM reduction bandwidth, "
                              "n=2^24",
                    "value": 12.3457, "unit": "GB/s",
                    "vs_baseline": round(12.3457 / 90.8413, 4)}
    assert round_cli.payload([_result(5.0, QAStatus.FAILED)], 1000)[
        "value"] == 0.0
    assert round_cli.payload([], 1000)["metric"].endswith("n=1000")


def test_provenance_carries_each_candidates_spread():
    cfg = types.SimpleNamespace(backend="cuda", kernel=6, threads=2048,
                                nbytes=4 << 20)
    got = round_cli.provenance([(cfg, _result(
        2000.0, QAStatus.PASSED, [2e-6, 4e-6, -1.0]))])
    assert got == {"cuda k6 threads=2048": {
        "gbps": 2000.0, "status": "PASSED",
        "gbps_spread": [round((4 << 20) / 4e-6 / 1e9, 1),
                        round((4 << 20) / 2e-6 / 1e9, 1)]}}


def test_round_exits_1_when_no_candidate_passes(in_tmp, capsys,
                                                monkeypatch):
    from tpu_reductions_torch.bench import driver
    monkeypatch.setattr(driver, "run_benchmark_batch",
                        lambda cfgs, logger=None: [
                            _result(0.0, QAStatus.FAILED)])
    rc = round_cli.main(ARGV)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1
    assert len(out) == 1 and json.loads(out[0])["value"] == 0.0


def test_round_refuses_a_non_positive_n(capsys):
    with pytest.raises(SystemExit) as exc:
        round_cli.main(["--platform=cpu", "--n=0"])
    assert exc.value.code == 2
