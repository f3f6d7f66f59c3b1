"""The port's preflight (utils/preflight.py), as tests/test_preflight.py
holds the JAX one: a sacrificial child makes the first device contact
under a hard timeout and the parent classifies LIVE / NO_RELAY / STALLED /
WEDGED, under the chaos relay (faults/relay.py) and a `preflight.probe`
stall; the health file both packages read; the CLI's exit codes. The
child runs on the CPU here (TPU_REDUCTIONS_PREFLIGHT_PLATFORM=cpu)."""

import json
import time

import pytest

from tpu_reductions.utils import preflight as jax_preflight
from tpu_reductions_torch.faults import inject
from tpu_reductions_torch.faults.relay import FakeRelay
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils import preflight
from tpu_reductions_torch.utils.jsonio import atomic_json_dump

STALL = json.dumps({"preflight.probe": {"action": "stall", "seconds": 60}})


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_REDUCTIONS_HEALTH_FILE",
                       str(tmp_path / "health.json"))
    monkeypatch.setenv("TPU_REDUCTIONS_PREFLIGHT_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the child's threads
    for name in (inject.ENV_VAR, "TPU_REDUCTIONS_RELAY_MARKER",
                 "TPU_REDUCTIONS_RELAY_PORTS", "TPU_REDUCTIONS_PREFLIGHT",
                 "TPU_REDUCTIONS_LEDGER"):
        monkeypatch.delenv(name, raising=False)
    ledger.disarm()
    yield
    ledger.disarm()


@pytest.fixture
def tunneled(monkeypatch, tmp_path):
    """A tunneled host pointed at a chaos relay; yields the relay."""
    marker = tmp_path / "relay.marker"
    marker.write_text("tunneled\n")
    with FakeRelay() as relay:
        monkeypatch.setenv("TPU_REDUCTIONS_RELAY_MARKER", str(marker))
        monkeypatch.setenv("TPU_REDUCTIONS_RELAY_PORTS", str(relay.port))
        yield relay


def test_live_card_classifies_live(tunneled):
    record = preflight.run_preflight(timeout_s=60.0)
    assert record["verdict"] == preflight.LIVE
    assert record["relay"] == "alive"
    assert "backend=cpu" in record["detail"]
    assert preflight.read_health()["verdict"] == preflight.LIVE


def test_untunneled_live_and_its_ledger_event(tmp_path):
    ledger.arm(tmp_path / "l.jsonl")
    record = preflight.run_preflight(timeout_s=60.0)
    assert record["verdict"] == preflight.LIVE
    assert record["relay"] == "untunneled"
    (ev,) = [json.loads(line) for line in
             (tmp_path / "l.jsonl").read_text().splitlines()]
    assert ev["ev"] == "preflight.verdict" and ev["verdict"] == "LIVE"


def test_scripted_wedge_classifies_wedged(tunneled, monkeypatch):
    monkeypatch.setenv(inject.ENV_VAR, STALL)
    t0 = time.monotonic()
    record = preflight.run_preflight(timeout_s=2.0)
    assert record["verdict"] == preflight.WEDGED
    assert record["relay"] == "alive"
    assert time.monotonic() - t0 < 30
    assert "hung past" in record["detail"]


def test_untunneled_hang_is_wedged(monkeypatch):
    """No relay to blame on a local card: a hung probe is WEDGED."""
    monkeypatch.setenv(inject.ENV_VAR, STALL)
    record = preflight.run_preflight(timeout_s=2.0)
    assert record["verdict"] == preflight.WEDGED
    assert record["relay"] == "untunneled"


def test_stalled_relay_classifies_stalled(tunneled, monkeypatch):
    tunneled.force("stall")
    monkeypatch.setenv(inject.ENV_VAR, STALL)
    record = preflight.run_preflight(timeout_s=2.0)
    assert record["verdict"] == preflight.STALLED


def test_dead_relay_classifies_no_relay_without_spawning(tunneled):
    tunneled.force("refuse")
    time.sleep(0.15)
    t0 = time.monotonic()
    record = preflight.run_preflight(timeout_s=60.0)
    assert record["verdict"] == preflight.NO_RELAY
    assert time.monotonic() - t0 < 10
    assert "not probed" in record["detail"]


def test_a_child_that_fails_is_not_live(monkeypatch):
    monkeypatch.setenv(inject.ENV_VAR, json.dumps(
        {"preflight.probe": {"action": "raise"}}))
    record = preflight.run_preflight(timeout_s=30.0)
    assert record["verdict"] == preflight.WEDGED
    assert "exited rc=1" in record["detail"]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_read_health_rejects_stale_and_garbage(tmp_path, side):
    mod = jax_preflight if side == "jax" else preflight
    health = tmp_path / "health.json"
    assert mod.read_health() is None
    health.write_text("{not json")
    assert mod.read_health() is None
    atomic_json_dump(health, {"verdict": "WEDGED", "ts": time.time() - 9999})
    assert mod.read_health() is None
    atomic_json_dump(health, {"verdict": "WEDGED", "ts": time.time()})
    assert mod.read_health()["verdict"] == "WEDGED"


def test_the_health_file_reads_the_same_in_both_packages(tmp_path):
    """A verdict the port wrote gates the JAX package, and the reverse:
    one file format."""
    preflight.run_preflight(timeout_s=60.0)
    assert jax_preflight.read_health() == preflight.read_health()
    assert jax_preflight.gate_verdict() == preflight.gate_verdict() == "LIVE"


def test_gate_verdict_modes(tmp_path, monkeypatch):
    health = tmp_path / "health.json"
    atomic_json_dump(health, {"verdict": "STALLED", "ts": time.time()})
    assert preflight.gate_verdict() == "STALLED"
    monkeypatch.setenv("TPU_REDUCTIONS_PREFLIGHT", "0")
    assert preflight.gate_verdict() is None
    monkeypatch.delenv("TPU_REDUCTIONS_PREFLIGHT")
    health.unlink()
    assert preflight.gate_verdict() is None        # passive: no child
    monkeypatch.setenv("TPU_REDUCTIONS_PREFLIGHT", "1")
    assert preflight.gate_verdict() == "LIVE"      # active: one child
    assert health.exists()


def test_cli_exit_codes_map_verdicts(tunneled, monkeypatch, capsys):
    assert preflight.main(["--timeout=60", "--platform=cpu"]) == 0
    tunneled.force("refuse")
    time.sleep(0.15)
    assert preflight.main(["--timeout=60", "--platform=cpu"]) == 3
    tunneled.force("accept")
    time.sleep(0.3)
    monkeypatch.setenv(inject.ENV_VAR, STALL)
    assert preflight.main(["--timeout=2", "--platform=cpu"]) == 4
    out = capsys.readouterr().out
    assert "preflight: LIVE" in out and "preflight: NO_RELAY" in out
