"""The port's execution core and cost oracle against the JAX package's:
plan validation with the JAX words, the exec.plan / exec.launch /
exec.done join of `run` for a success, a failure, a transient flap and a
dead relay, the compile seam's dedupe, and every decision of the
`--explain` grid on one evidence fixture (the model constants of both
oracles patched to equal values here, in the test only). The port's own
constants are tested on their own."""

import json
import socket

import pytest

from tpu_reductions.exec import __main__ as jax_explain
from tpu_reductions.exec import core as jax_core
from tpu_reductions.exec import cost as jax_cost
from tpu_reductions.exec import plan as jax_plan
from tpu_reductions.faults import inject as jax_inject
from tpu_reductions.obs import ledger as jax_ledger
from tpu_reductions.utils import heartbeat as jax_heartbeat
from tpu_reductions_torch.exec import __main__ as port_explain
from tpu_reductions_torch.exec import core as port_core
from tpu_reductions_torch.exec import cost as port_cost
from tpu_reductions_torch.exec import plan as port_plan
from tpu_reductions_torch.faults import inject as port_inject
from tpu_reductions_torch.obs import ledger as port_ledger
from tpu_reductions_torch.utils import heartbeat as port_heartbeat

SIDES = {"jax": (jax_plan, jax_core, jax_ledger, jax_inject, jax_heartbeat),
         "port": (port_plan, port_core, port_ledger, port_inject,
                  port_heartbeat)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("TPU_REDUCTIONS_LEDGER", "TPU_REDUCTIONS_FAULTS",
                 "TPU_REDUCTIONS_RELAY_MARKER", "TPU_REDUCTIONS_RELAY_PORTS",
                 "TPU_REDUCTIONS_EVIDENCE_ROOT",
                 "TPU_REDUCTIONS_DEVICE_RETRIES"):
        monkeypatch.delenv(name, raising=False)
    for plan, core, ledger, inject, heartbeat in SIDES.values():
        ledger.disarm()
        inject.reset()
        heartbeat.reset()
        core.reset_observed()
    yield
    for plan, core, ledger, inject, heartbeat in SIDES.values():
        ledger.disarm()
        inject.reset()
        core.reset_observed()


def _lines(path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _shape(lines: list) -> list:
    """Keys in order and fields with ids renamed by first appearance;
    `t`, `pid` and the measured seconds dropped."""
    names = {}
    out = []
    for rec in lines:
        fields = {}
        for k, v in rec.items():
            if k in ("t", "pid", "wall_s", "delay_s", "dur_s"):
                continue
            fields[k] = (names.setdefault(v, f"id{len(names)}")
                         if k in ("trace", "span", "parent") else v)
        out.append((list(rec), fields))
    return out


@pytest.mark.parametrize("kwargs", [
    dict(surface="s", kind="nope", builder=lambda c: 1),
    dict(surface="s", kind="serve", builder=lambda c: 1, timing="nope"),
    dict(surface="s", kind="serve"),
], ids=["kind", "timing", "builder"])
def test_plan_validation_refuses_with_jax_words(kwargs):
    msgs = []
    for plan in (jax_plan, port_plan):
        with pytest.raises(ValueError) as e:
            plan.LaunchPlan(**kwargs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_launch_plan_and_device_task_match_jax():
    def build(ctx):
        return 1
    for make in ("launch_plan", "device_task"):
        plans = []
        for plan in (jax_plan, port_plan):
            fn = getattr(plan, make)
            p = (fn("serve-bucket/sum", "serve", build, timing="serve",
                    heartbeat_phase="serve", retry=True, drain=True,
                    staging_bound=64, n=3, batch=4, method="SUM")
                 if make == "launch_plan" else
                 fn("spot/sum", lambda: 1, method="SUM", n=5))
            plans.append((p.surface, p.kind, p.timing, p.geometry,
                          p.contract.heartbeat_phase, p.contract.retry,
                          p.contract.staging_bound, p.contract.drain))
        assert plans[0] == plans[1]


def _relay(monkeypatch, tmp_path, alive: bool):
    """Declare the host tunneled, its relay port listening or not."""
    marker = tmp_path / "relay-marker"
    marker.write_text("")
    monkeypatch.setenv("TPU_REDUCTIONS_RELAY_MARKER", str(marker))
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    if alive:
        srv.listen(4)
    else:
        srv.close()
    monkeypatch.setenv("TPU_REDUCTIONS_RELAY_PORTS", str(port))
    return srv


class _Flaky:
    def __init__(self, fails: int):
        self.fails, self.calls = fails, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise RuntimeError(f"flap {self.calls}")
        return 42


@pytest.mark.parametrize("case", ["ok", "fails", "flap", "dead-relay",
                                  "guarded", "unguarded", "fault"])
def test_run_join_matches_jax(case, tmp_path, monkeypatch):
    if case in ("flap", "dead-relay"):
        srv = _relay(monkeypatch, tmp_path, alive=(case == "flap"))
    if case == "fault":
        monkeypatch.setenv("TPU_REDUCTIONS_FAULTS", json.dumps(
            {"exec.launch": {"times": 1, "message": "scripted"}}))
    shapes, outcomes = {}, {}
    for side, (plan, core, ledger, inject, _) in SIDES.items():
        path = tmp_path / f"{side}.jsonl"
        ledger.arm(path)
        fn = _Flaky(0 if case in ("ok", "guarded", "unguarded", "fault")
                    else 1 if case in ("flap", "dead-relay") else 99)
        if case in ("guarded", "unguarded"):
            p = plan.launch_plan(
                "reshard", "reshard", lambda ctx: (ctx.tick(), fn())[1],
                timing="steps",
                heartbeat_phase="x" if case == "guarded" else None,
                ranks=4)
        else:
            p = plan.device_task(f"spot/{case}", fn, method="SUM", n=8)
        try:
            outcomes[side] = (core.run(p), fn.calls)
        except Exception as e:
            outcomes[side] = (f"{type(e).__name__}: {e}", fn.calls)
        ledger.disarm()
        shapes[side] = _shape(_lines(path))
    assert outcomes["port"] == outcomes["jax"]
    assert shapes["port"] == shapes["jax"]
    evs = [f["ev"] for _, f in shapes["port"]]
    assert evs[0] == "exec.plan"
    if case == "fault":
        assert "exec.launch" not in evs and "exec.done" not in evs
    else:
        done = [f for _, f in shapes["port"] if f["ev"] == "exec.done"]
        assert len(done) == 1
        assert done[0]["ok"] is (case not in ("fails", "dead-relay"))
    if case in ("flap", "dead-relay"):
        srv.close()


def test_observe_compile_dedupes_by_key(tmp_path):
    starts = {}
    for side, (plan, core, ledger, inject, _) in SIDES.items():
        path = tmp_path / f"{side}.jsonl"
        ledger.arm(path)
        for key in ("a", "a", "b", None, None, "a"):
            with core.observe_compile("serve-bucket/sum", key=key, n=4,
                                      batch=1) as obs:
                if obs is not None:
                    obs["extra"] = 1
        ledger.disarm()
        lines = _lines(path)
        starts[side] = [r["ev"] for r in lines]
        ends = [r for r in lines if r["ev"] == "compile.end"]
        assert all(r["surface"] == "serve-bucket/sum" and r["n"] == 4
                   and r["extra"] == 1 and r["dur_s"] >= 0 for r in ends)
    assert starts["port"] == starts["jax"]
    assert starts["port"].count("compile.start") == 4
    port_core.reset_observed()
    with port_core.observe_compile("s", key="a") as obs:
        assert obs is not None


def test_observe_compile_records_the_error(tmp_path):
    port_ledger.arm(tmp_path / "l.jsonl")
    with pytest.raises(KeyError):
        with port_core.observe_compile("seam"):
            raise KeyError("boom")
    port_ledger.disarm()
    end = _lines(tmp_path / "l.jsonl")[-1]
    assert end["ev"] == "compile.end" and end["error"].startswith("KeyError")


# ------------------------------------------------------------ the oracle

def _evidence(overlap: float = 1.6) -> dict:
    """One fixture of every artifact the oracle reads, by evidence key."""
    return {
        "autotune": {"ranked": [
            {"kernel": 6, "threads": 256, "gbps": 2400.0,
             "status": "PASSED"},
            {"kernel": 6, "threads": 512, "gbps": 2450.5,
             "status": "PASSED"},
            {"kernel": 10, "threads": 512, "gbps": 2300.0,
             "status": "PASSED"},
            {"kernel": 8, "threads": 128, "gbps": 9999.0,
             "status": "FAILED"}]},
        "stream": {"rows": [
            {"chunk": 0, "status": "PASSED"},
            {"final": True, "status": "PASSED",
             "overlap_efficiency": overlap}]},
        "compile": {"kind": "compile-observatory", "version": 1,
                    "complete": True, "surfaces": [
                        {"surface": "k10@4", "verdict": "cold",
                         "compile_s": None},
                        {"surface": "k6", "verdict": "cold",
                         "compile_s": 12.5},
                        {"surface": "mxu-scan", "verdict": "cold",
                         "compile_s": 0.0},
                        {"surface": "xla-cumsum", "verdict": "warm"}]},
        "scaling": {"series": {"INT SUM": [[2, 3.5], [8, 8.25]],
                               "DOUBLE MAX": [[2, 1.5], [64, 10.0]]}},
        "quant": {"rows": [
            {"method": "SUM", "bits": 8, "wire_reduction": 3.5,
             "status": "PASSED"},
            {"method": "SUM", "bits": 8, "wire_reduction": 3.9,
             "status": "PASSED"},
            {"method": "SUM", "bits": 8, "wire_reduction": 3.7,
             "status": "PASSED"},
            {"method": "SUM", "bits": 4, "wire_reduction": 6.0,
             "status": "PASSED"}]},
        "family": {"rows": [
            {"method": "SCAN", "dtype": "float32", "impl": "mxu-scan",
             "gbps": 480.0, "status": "PASSED"},
            {"method": "SCAN", "dtype": "float32", "impl": "xla-cumsum",
             "gbps": 560.0, "status": "PASSED"},
            {"method": "SCAN", "dtype": "int32", "impl": "xla-cumsum",
             "gbps": 600.0, "status": "PASSED"}]},
    }


def _write_evidence(root, docs: dict, *mods) -> None:
    for mod in mods:
        for key, doc in docs.items():
            path = root / mod._EVIDENCE[key]
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(doc))


def _normalized(rows: list, mod) -> list:
    """Rows with evidence paths as their keys, and the regime word of the
    kernel axis's reason the port changed (the card has an L2 where the
    TPU had VMEM) spelled one way."""
    keys = {path: key for key, path in mod._EVIDENCE.items()}
    out = []
    for r in rows:
        r = dict(r, evidence=[keys[p] for p in r["evidence"]])
        r["reason"] = (r["reason"].replace("VMEM residency", "residency")
                       .replace("L2 residency", "residency")
                       .replace("deep-DMA overlap", "overlap")
                       .replace("stream overlap", "overlap"))
        out.append(r)
    return out


@pytest.mark.parametrize("evidence", ["full", "empty", "slow-stream",
                                      "partial"])
def test_every_grid_decision_matches_jax(evidence, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_cost, "_RESIDENT_BYTES",
                        port_cost._RESIDENT_BYTES)
    monkeypatch.setattr(jax_cost, "_HBM_RATE", port_cost._HBM_RATE)
    docs = {"full": _evidence(), "empty": {},
            "slow-stream": _evidence(overlap=0.8),
            "partial": {k: v for k, v in _evidence().items()
                        if k in ("autotune", "quant")}}[evidence]
    _write_evidence(tmp_path, docs, jax_cost, port_cost)
    jax_rows = jax_explain.decision_rows(jax_cost.CostOracle(str(tmp_path)))
    port_rows = port_explain.decision_rows(
        port_cost.CostOracle(str(tmp_path)))
    assert len(port_rows) == len(jax_rows) == 19
    assert _normalized(port_rows, port_cost) == \
        _normalized(jax_rows, jax_cost)
    if evidence == "full":
        assert set(port_explain.flipped_axes(port_rows)) == {
            "kernel", "topology", "wire"}


def test_the_evidence_root_env_and_the_select_events(tmp_path, monkeypatch):
    _write_evidence(tmp_path, _evidence(), port_cost)
    monkeypatch.setenv("TPU_REDUCTIONS_EVIDENCE_ROOT", str(tmp_path))
    oracle = port_cost.CostOracle()
    assert oracle.root == str(tmp_path)
    port_ledger.arm(tmp_path / "l.jsonl")
    rows = port_explain.decision_rows(oracle)
    port_ledger.disarm()
    sel = [r for r in _lines(tmp_path / "l.jsonl")
           if r["ev"] == "exec.select"]
    assert len(sel) == len(rows)
    assert [s["choice"] for s in sel] == [r["choice"] for r in rows]


def test_the_kernel_axis_flips_at_the_l2_bound(tmp_path):
    """The port's own constants: 50 MiB of L2, 3.35 TB/s of HBM."""
    assert port_cost._RESIDENT_BYTES == 50 << 20
    assert port_cost._HBM_RATE == 3.35e12
    _write_evidence(tmp_path, _evidence(), port_cost)
    oracle = port_cost.CostOracle(str(tmp_path))
    at = oracle.pick_kernel("SUM", "int32", (50 << 20) // 4)
    past = oracle.pick_kernel("SUM", "int32", (50 << 20) // 4 + 1)
    assert (at.choice, past.choice) == ("k6", "k10")
    assert "L2 residency bound" in at.reason and past.flipped
    k6_s = dict(at.candidates)["k6"]
    assert k6_s == pytest.approx((50 << 20) / 2450.5e9)
    # the comparator's rows carry no kernel and price nothing
    doc = _evidence()
    doc["autotune"]["ranked"].append({"kernel": None, "gbps": 1e6,
                                      "status": "PASSED"})
    _write_evidence(tmp_path, doc, port_cost)
    assert port_cost.CostOracle(str(tmp_path)).kernel_rates() == {
        6: 2450.5, 10: 2300.0}
    # no k6 row: the static pick
    doc["autotune"]["ranked"] = [{"kernel": 10, "gbps": 1.0,
                                  "status": "PASSED"}]
    _write_evidence(tmp_path, doc, port_cost)
    d = port_cost.CostOracle(str(tmp_path)).pick_kernel("SUM", "int", 1)
    assert (d.choice, d.evidence) == ("k6", ())


def test_decisions_markdown_matches_jax(tmp_path):
    _write_evidence(tmp_path, _evidence(), port_cost)
    rows = port_explain.decision_rows(port_cost.CostOracle(str(tmp_path)))
    doc = {"rows": rows}
    port_md = port_cost.decisions_markdown(doc).splitlines()
    jax_md = jax_cost.decisions_markdown(doc).splitlines()
    assert [ln for ln in port_md if ln.startswith("|")] == \
        [ln for ln in jax_md if ln.startswith("|")]
    assert port_md[-1] == jax_md[-1]
    assert port_cost.decisions_markdown({"rows": []}) == ""


def test_explain_cli_writes_the_artifact(tmp_path, capsys):
    _write_evidence(tmp_path, _evidence(), port_cost)
    out = tmp_path / "exec_decisions.json"
    assert port_explain.main(["--explain", "--platform=cpu",
                              f"--evidence-root={tmp_path}",
                              f"--out={out}"]) == 0
    text = capsys.readouterr().out
    assert "19 decisions; regime flips on axes: kernel, topology, wire" \
        in text
    doc = json.loads(out.read_text())
    assert (doc["kind"], doc["complete"], doc["platform"]) == (
        "exec-decisions", True, "cpu")
    assert len(doc["rows"]) == 19
    assert port_explain.main(["--explain", "--platform=cpu",
                              f"--evidence-root={tmp_path / 'none'}"]) == 0
    assert "NONE (evidence missing?)" in capsys.readouterr().out
