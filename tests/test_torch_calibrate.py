"""The port's timing calibration (utils/calibrate.py): a CPU run of the
ladder CLI with its resumable artifact, and the verdict rule held against
the JAX package's TimingCalibration on the same five numbers."""

import json
import math

import pytest

from tpu_reductions.utils.calibrate import \
    TimingCalibration as JaxCalibration
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils import calibrate
from tpu_reductions_torch.utils.calibrate import TimingCalibration

# (single, amortized, roundtrip, chained, post-fetch) seconds: an honest
# sync, a broken one (dispatch acknowledged), the boundary, an
# indeterminate slope, a chain whose fold costs a copy
CASES = {
    "honest": (30e-6, 29e-6, 200e-6, 30e-6, 31e-6),
    "broken": (26e-6, 20e-6, 30e-3, 1.2e-3, 1.1e-3),
    "boundary": (0.25e-3, 0.2e-3, 1e-3, 1e-3, 0.3e-3),
    "below": (0.2499e-3, 0.2e-3, 1e-3, 1e-3, 0.3e-3),
    "indeterminate": (30e-6, 29e-6, 200e-6, -1e-6, 31e-6),
    "zero slope": (30e-6, 29e-6, 200e-6, 0.0, 31e-6),
    "copying chain": (30e-6, 10e-6, 200e-6, 35e-6, 31e-6),
}


def _pair(values, dtype="float32", n=1 << 24):
    fields = dict(zip(("single_blocked_s", "amortized_blocked_s",
                       "roundtrip_s", "chained_per_iter_s",
                       "post_fetch_single_blocked_s"), values))
    return (TimingCalibration(platform="gpu", n=n, dtype=dtype, **fields),
            JaxCalibration(platform="gpu", n=n, dtype=dtype, **fields))


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdict_rule_matches_the_jax_rule(case):
    port, ref = _pair(CASES[case])
    assert port.block_awaits_execution == ref.block_awaits_execution
    assert port.indeterminate == ref.indeterminate
    for a, b in ((port.chain_overhead_ratio, ref.chain_overhead_ratio),
                 (port.honest_gbps, ref.honest_gbps)):
        assert (math.isnan(a) and math.isnan(b)) or a == pytest.approx(b)
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("case", sorted(CASES))
def test_describe_says_the_verdict(case):
    port, _ = _pair(CASES[case])
    text = port.describe()
    if port.indeterminate:
        assert "INDETERMINATE" in text
    elif port.block_awaits_execution:
        assert "timed loops are trustworthy" in text
    else:
        assert "use --timing=chained" in text


def test_a_cpu_run_measures_all_five(tmp_path):
    cal = calibrate.calibrate(n=1 << 14, reps=2, chain_span=8,
                              platform="cpu")
    assert cal.platform == "cpu" and cal.n == 1 << 14
    for name in ("single_blocked_s", "amortized_blocked_s", "roundtrip_s",
                 "post_fetch_single_blocked_s"):
        assert getattr(cal, name) > 0
    assert isinstance(cal.block_awaits_execution, bool)
    json.dumps(cal.to_dict())                    # strict JSON


def test_ladder_cli_persists_and_resumes_its_rungs(tmp_path, capsys):
    out = tmp_path / "cal.json"
    ledger.arm(tmp_path / "l.jsonl")
    argv = ["--ladder", "--platform=cpu", "--n=16384", "--chainspan=8",
            "--reps=2", f"--out={out}"]
    assert calibrate.main(argv) == 0
    data = json.loads(out.read_text())
    assert data["complete"] is True and len(data["rungs"]) == 2
    assert [r["n"] for r in data["rungs"]] == [16384, 65536]
    assert data["deciding_n"] == 65536
    assert data["block_awaits_execution"] \
        == data["rungs"][1]["block_awaits_execution"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["complete"] is True
    # an interrupted ladder (its first rung only) resumes that rung
    first = data["rungs"][0]
    out.write_text(json.dumps({"dtype": "float32", "chain_span": 8,
                               "reps": 2, "complete": False,
                               "rungs": [first]}))
    assert calibrate.main(argv) == 0
    assert "rung n=16384 resumed" in capsys.readouterr().out
    again = json.loads(out.read_text())
    assert again["rungs"][0] == first and again["complete"] is True
    evs = [json.loads(line)["ev"] for line in
           (tmp_path / "l.jsonl").read_text().splitlines()]
    assert "resume.reuse" in evs and "chain.trip" in evs
