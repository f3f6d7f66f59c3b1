"""The check that decides `correct`, shown to fail: each cell driven on
the CPU (the kernels' plain versions, gloo between four processes) at a
small size, with the timed path broken underneath, comes out not
correct; sound runs come out correct; and so does the control, the
reference in float32 in the program's place, come out not correct."""

import pytest

from portbench import control, harness
from portbench.tests import full_spec

SPEC = full_spec()
FAULTS = "portbench.tests.faults:"


def _cell(name):
    cell = harness.resolve(SPEC, name)
    if cell.config["driver"] == "single_device":
        # 512 staged rows, no padding: half of them is half the payload
        cell.traffic = dict(cell.traffic, n={"int32": 1 << 16,
                                             "float64": 1 << 16},
                            payloads=4, trace_calls=20, collect_every=16)
    else:
        cell.traffic = dict(cell.traffic, bytes_per_dtype=8 * 8 * 1024,
                            trace_collectives=12)
    return cell


def _run(name, entry, seconds=0.5, seed=2**31 + 99):
    return harness.run_cell(_cell(name), seed, seconds, False,
                            platform="cpu", entry=entry)


@pytest.mark.parametrize("name", ["sdk_reduction.awaited-2e24",
                                  "sdk_reduction.awaited-2gib"])
def test_sound_single_device_runs_are_correct(name):
    out = _run(name, None)
    assert out.correct, out.checks
    assert out.attempted >= 6 and out.failed == 0


@pytest.mark.parametrize("fault", ["sdk_stale", "sdk_half", "sdk_altered",
                                   "control"])
def test_a_broken_single_device_path_is_not_correct(fault):
    name = "sdk_reduction.awaited-2e24"
    entry = (control.control_entry(_cell(name)) if fault == "control"
             else FAULTS + fault)
    out = _run(name, entry)
    assert not out.correct
    assert out.failed > 0


def test_sound_collective_run_is_correct():
    out = _run("mpi_reduce.vn8-root-2gib", None, seconds=1.0)
    assert out.correct, out.checks
    assert out.count == 4 and out.attempted >= 6


@pytest.mark.parametrize("fault", ["mpi_no_exchange", "mpi_unchanged",
                                   "mpi_half", "mpi_altered", "control"])
def test_a_broken_collective_is_not_correct(fault):
    name = "mpi_reduce.vn8-root-2gib"
    entry = (control.control_entry(_cell(name)) if fault == "control"
             else FAULTS + fault)
    out = _run(name, entry, seconds=1.0)
    assert not out.correct
    assert out.failed > 0


def test_the_limits_sit_between_the_readings():
    """The control's readings on the CPU at this size lie above every
    limit they are held to, by a factor; the sound runs' below."""
    name = "mpi_reduce.vn8-root-2gib"
    low = _run(name, control.control_entry(_cell(name)), seconds=1.0)
    assert low.checks["f64_sum_gap"][0] > 100 * low.checks["f64_sum_gap"][1]
    assert low.checks["exact_mismatch"][0] > 0
