"""On the card (marked `gpu`; each skips where there is none): every
one-card cell at its own size for a short window comes out correct, and
its control does not."""

import json
import subprocess
import sys

import pytest

from portbench import control, harness

SPEC = harness.load_spec()
ONE_CARD = sorted(w["name"] for w in SPEC["workloads"] if w["chips"] == 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ONE_CARD)
def test_a_short_run_on_the_card_is_correct(card, name):
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        name, "--seed", str(2**31 + 17), "--seconds", "2",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=360, cwd=harness.BENCH_DIR.parent)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ONE_CARD)
def test_the_control_on_the_card_is_not_correct(card, name):
    cell = harness.resolve(SPEC, name)
    out = harness.run_cell(cell, 2**31 + 18, 1.0, False,
                           entry=control.control_entry(cell))
    assert not out.correct
