"""The stuck kernel: the `spin` fault (faults/inject.py), the spin kernel's
wrapper (ops/_cuda.spin_wait, csrc/fault.cu) and the watchdog's exit path
that must end a process whose main thread waits on that kernel.

On the CPU: the spec fires only at the point it names and only after its
`after` hits; on a CPU device the action raises at once and sleeps
nowhere; the wrapper caps its seconds at the kernel's 30 s and counts its
launches apart from the six ported kernels; and `_check_hang`'s exit
path, the ledger's `watchdog.exit` included, makes no `torch.cuda` call,
which on the card would queue behind the spinning kernel. On the card
(`gpu`): chip_smoke.py's rehearsal, the main CLI's chained k6 row ended
with exit 4 by a real spinning kernel, then preflight LIVE and the row
PASSED."""

import contextlib
import inspect
import json
import os
import re
import runpy
import shutil
import time
from pathlib import Path

import pytest
import torch

import tpu_reductions_torch.utils.watchdog as port_wd
from tpu_reductions_torch.faults import inject
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.ops import _cuda, chain
from tpu_reductions_torch.utils import heartbeat

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("TPU_REDUCTIONS_LEDGER", "TPU_REDUCTIONS_FAULTS",
                 "TPU_REDUCTIONS_HEARTBEAT_DEADLINE_S"):
        monkeypatch.delenv(name, raising=False)
    inject.reset()
    heartbeat.reset()
    ledger.disarm()
    yield
    inject.reset()
    heartbeat.reset()
    ledger.disarm()


def _plan(monkeypatch, **spec):
    monkeypatch.setenv(inject.ENV_VAR, json.dumps(
        {"chain.step": {"action": "spin", **spec}}))


@pytest.fixture
def launched(monkeypatch):
    """The spin launches the action asks for, as (seconds, device), with
    the run's device a card."""
    calls = []
    monkeypatch.setattr(_cuda, "spin_wait",
                        lambda seconds, device: calls.append(
                            (seconds, device)))
    monkeypatch.setattr(inject, "_run_device",
                        lambda: torch.device("cuda", 0))
    return calls


def test_the_spin_spec_fires_only_at_its_point(monkeypatch, launched):
    _plan(monkeypatch, seconds=20)
    for name in ("exec.launch", "heartbeat.tick", "bench.run"):
        assert inject.fault_point(name) is None
    assert launched == []
    spec = inject.fault_point("chain.step")
    assert spec == {"action": "spin", "seconds": 20}
    assert launched == [(20.0, torch.device("cuda", 0))]


def test_the_spin_spec_is_inert_without_a_plan(launched):
    assert inject.fault_point("chain.step") is None
    assert launched == []


@pytest.mark.parametrize("after, times, fired_at", [
    (0, None, [0, 1, 2, 3]), (2, 1, [2]), (1, 2, [1, 2])])
def test_the_spin_spec_keeps_after_and_times(monkeypatch, launched, after,
                                             times, fired_at):
    spec = {"seconds": 5, "after": after}
    if times is not None:
        spec["times"] = times
    _plan(monkeypatch, **spec)
    fired = []
    for hit in range(4):
        n = len(launched)
        inject.fault_point("chain.step")
        if len(launched) > n:
            fired.append(hit)
    assert fired == fired_at


def test_the_spin_seconds_default_to_20(monkeypatch, launched):
    _plan(monkeypatch)
    inject.fault_point("chain.step")
    assert launched == [(20.0, torch.device("cuda", 0))]


def test_the_spin_fires_after_its_ledger_event(tmp_path, monkeypatch,
                                               launched):
    ledger.arm(tmp_path / "l.jsonl")
    _plan(monkeypatch, seconds=3, after=2)
    for _ in range(3):
        inject.fault_point("chain.step")
    evs = [json.loads(line) for line in
           (tmp_path / "l.jsonl").read_text().splitlines()]
    fires = [e for e in evs if e["ev"] == "fault.fire"]
    assert [(e["point"], e["action"], e["hit"]) for e in fires] == [
        ("chain.step", "spin", 2)]


def test_on_the_cpu_the_action_raises_and_sleeps_nowhere(monkeypatch):
    """No card: the run's device is the CPU, and the stall has no host
    stand-in."""
    if torch.cuda.is_available():
        pytest.skip("the run's device is the card here")
    _plan(monkeypatch, seconds=20)
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    before = _cuda.spin_wait.launches
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no host stand-in"):
        inject.fault_point("chain.step")
    assert time.monotonic() - t0 < 5
    assert slept == [] and _cuda.spin_wait.launches == before


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_spin_wait_raises_on_a_cpu_device(device):
    before = _cuda.spin_wait.launches
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _cuda.spin_wait(1.0, device)
    assert _cuda.spin_wait.launches == before


@pytest.mark.parametrize("seconds, ns", [
    (0, 0), (-3, 0), (0.25, 250_000_000), (20, 20_000_000_000),
    (30, 30_000_000_000), (31, 30_000_000_000), (3600, 30_000_000_000)])
def test_spin_seconds_are_capped_at_30(seconds, ns):
    assert _cuda.spin_ns(seconds) == ns


def test_the_kernel_caps_its_spin_at_the_wrappers_cap():
    src = (REPO / "tpu_reductions_torch" / "csrc" / "fault.cu").read_text()
    m = re.search(r"SPIN_CAP_NS\s*=\s*(\d+)ull\s*\*\s*(\d+)ull", src)
    assert m and int(m.group(1)) * int(m.group(2)) == \
        _cuda.spin_ns(_cuda.SPIN_CAP_S) == 30 * 10**9
    assert "%globaltimer" in src


def test_spin_wait_launches_capped_and_counted_apart(monkeypatch):
    """The wrapper's path on a card, its library and stream stubbed: the
    capped nanoseconds reach the C entry, and the launch is counted on
    spin_wait.launches, never on a ported kernel's counter."""
    got = []

    class Lib:
        def tr_spin_wait(self, ns, stream):
            got.append((ns, stream))
            return 0

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(_cuda, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    ported = [w.launches for w in chain.counted_wrappers()]
    before = _cuda.spin_wait.launches
    _cuda.spin_wait(45, "cuda")
    _cuda.spin_wait(2.5, torch.device("cuda", 0))
    assert got == [(30_000_000_000, 1234), (2_500_000_000, 1234)]
    assert _cuda.spin_wait.launches == before + 2
    assert [w.launches for w in chain.counted_wrappers()] == ported
    assert _cuda.spin_wait not in chain.counted_wrappers()


def test_the_exit_path_makes_no_cuda_call(tmp_path, monkeypatch):
    """`_check_hang` from the snapshot to its `watchdog.exit` event and
    its exit, with every torch.cuda callable made to raise: on the card
    any such call would wait behind the spinning kernel, and exit 4
    would never come."""
    def refuse(*args, **kwargs):
        raise AssertionError("a torch.cuda call on the exit path")

    for name, obj in vars(torch.cuda).items():
        if not name.startswith("__") and callable(obj) \
                and not inspect.ismodule(obj):
            monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setenv("TPU_REDUCTIONS_HEARTBEAT_DEADLINE_S", "0.05")
    ledger.arm(tmp_path / "l.jsonl")
    codes = []
    with heartbeat.guard("chained"):
        time.sleep(0.1)
        port_wd._check_hang("untunneled", None, codes.append)
    assert codes == [4]
    (ev,) = [json.loads(line) for line in
             (tmp_path / "l.jsonl").read_text().splitlines()
             if json.loads(line)["ev"] == "watchdog.exit"]
    assert ev["code"] == 4 and ev["phase"] == "chained"


@pytest.mark.gpu
def test_a_stuck_kernel_ends_its_run_with_exit_4(tmp_path):
    """chip_smoke.py's rehearsal on the card: the main CLI's chained k6
    row at int32 SUM 2^24 with a 20 s spin on its first timed trip exits
    4 within the deadline plus two watchdog intervals of the fault; then
    preflight LIVE and the same row PASSED."""
    if not torch.cuda.is_available() or shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU with nvcc: run `python -m pytest "
                    "-m gpu --noconftest tests/test_torch_stuck_kernel.py` "
                    "on the card")
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="not_main")
    env = {**os.environ, "TPU_REDUCTIONS_LEDGER": str(tmp_path / "l.jsonl"),
           "TPU_REDUCTIONS_HEALTH_FILE": str(tmp_path / "health.json")}
    env.pop("TPU_REDUCTIONS_FAULTS", None)
    smoke["spin_rehearsal"](env, tmp_path)
