"""The port's fault points at the JAX sites' counterparts: `family.cell`
(bench/family_spot.py), `reshard.cell` (bench/reshard_curve.py),
`collective.hop` (bench/collective_driver.py, driven by the sweep) and
`staging.chunk` (utils/staging.py, driven by spot on a payload staged in
chunks). Each CLI is cut there with exit 3, then run again: the rerun
resumes the rows the cut left (byte for byte), finishes, and its rows
equal an uninterrupted run's, timings aside."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
# measured seconds and rates, which no two runs share
TIMING = {"gbps", "per_iter_s", "span", "avg_s", "slope_samples_s",
          "wall_s", "latency_s", "steps", "seconds", "time_s",
          "busbw_gbps", "reference_gbps", "dt_s"}

CASES = {
    "family.cell": dict(
        argv=["tpu_reductions_torch.bench.family_spot", "--n=16384",
              "--serve-n=4096", "--segments=16", "--reps=2",
              "--platform=cpu", "--out={out}"],
        artifact="{out}", after=4),
    "reshard.cell": dict(
        argv=["tpu_reductions_torch.bench.reshard_curve", "--ranks=2,4",
              "--n=65536", "--rows=64", "--platform=cpu", "--out={out}"],
        artifact="{out}", after=5),
    "collective.hop": dict(
        argv=["tpu_reductions_torch.bench.sweep", "--out-dir={dir}",
              "--ranks=2,4,8", "--types=int", "--methods=SUM,MIN",
              "--n=4096", "--retries=2", "--platform=cpu"],
        artifact="{dir}/collective_sweep.json", after=2),
    "staging.chunk": dict(
        argv=["tpu_reductions_torch.bench.spot", "--type=int",
              "--methods=SUM,MIN,MAX", "--n=65536", "--iterations=4",
              "--chainreps=2", "--platform=cpu", "--out={out}"],
        artifact="{out}", after=9,
        env={"TPU_REDUCTIONS_STAGE_THRESHOLD_BYTES": "4096",
             "TPU_REDUCTIONS_STAGE_CHUNK_BYTES": "32768"}),
}


def _run(case, d: Path, fault=None):
    spec = CASES[case]
    fmt = {"out": str(d / "out.json"), "dir": str(d)}
    env = {**os.environ, "OMP_NUM_THREADS": "1", **spec.get("env", {})}
    for name in ("TPU_REDUCTIONS_FAULTS", "TPU_REDUCTIONS_LEDGER"):
        env.pop(name, None)
    if fault is not None:
        env["TPU_REDUCTIONS_FAULTS"] = json.dumps(fault)
    d.mkdir(exist_ok=True)
    r = subprocess.run([sys.executable, "-m",
                        *[a.format(**fmt) for a in spec["argv"]]],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    return r, Path(spec["artifact"].format(**fmt))


def _steady(row: dict) -> dict:
    """A row without its timings; a chained verdict counts as banked
    (PASSED or WAIVED, bench/resume.default_reusable)."""
    out = {k: v for k, v in row.items() if k not in TIMING}
    if out.get("status") in ("PASSED", "WAIVED"):
        out["status"] = "banked"
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_cut_at_the_fault_point_then_resumed(tmp_path, case):
    control, path = _run(case, tmp_path / "control")
    assert control.returncode == 0, control.stderr[-2000:]
    want = json.loads(path.read_text())
    assert want["complete"] is True

    fault = {case: {"after": CASES[case]["after"], "action": "exit",
                    "code": 3}}
    cut, path = _run(case, tmp_path / "cut", fault)
    assert cut.returncode == 3, cut.stderr[-2000:]
    partial = json.loads(path.read_text())
    assert partial["complete"] is False
    assert 0 < len(partial["rows"]) < len(want["rows"])

    resumed, path = _run(case, tmp_path / "cut")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    got = json.loads(path.read_text())
    assert got["complete"] is True
    # the cut's rows are reused untouched, then the rest is measured
    for row in partial["rows"]:
        assert row in got["rows"]
    assert sorted(map(json.dumps, map(_steady, got["rows"]))) \
        == sorted(map(json.dumps, map(_steady, want["rows"])))
