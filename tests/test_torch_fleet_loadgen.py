"""The port load generator's fleet modes against the JAX package's, on the
CPU: --scale, --elastic and --recovery at test scale write the artifact
keys and row grammar of the JAX CLI's committed artifacts
(examples/tpu_run/serving_{scale,elastic,recovery}.json), each mode's
markdown is the JAX one for the same artifact, an artifact left
incomplete resumes, the diurnal plan, the trajectory compression, the
idempotency stamps and the ledger-joined recovery audit are the JAX
ones, and bench/regen folds the three artifacts into the report."""

import json
import random
from pathlib import Path

import pytest

from tpu_reductions.faults import inject as jax_inject
from tpu_reductions.serve import loadgen as jax_loadgen
from tpu_reductions_torch.faults import inject as port_inject
from tpu_reductions_torch.serve import loadgen as port_loadgen

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples" / "tpu_run"

# what the port's rows add to the JAX rows: the sharded row's host seconds
# of fill, fold, combine and verify, and the routers' spawn lines of the
# kill-router scenario
PORT_EXTRA = {"sharded": {"seconds", "cards"}, "kill_router": {"routers"}}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("TPU_REDUCTIONS_FAULTS", "TPU_REDUCTIONS_LEDGER",
                 "TPU_REDUCTIONS_AUTOSCALE_MIN", "TPU_REDUCTIONS_AUTOSCALE_MAX",
                 "TPU_REDUCTIONS_AUTOSCALE_COOLDOWN_S"):
        monkeypatch.delenv(name, raising=False)
    jax_inject.reset()
    port_inject.reset()
    yield
    jax_inject.reset()
    port_inject.reset()


def _jax_artifact(name):
    return json.loads((EXAMPLES / f"serving_{name}.json").read_text())


def _row_kind(mode, row):
    if mode == "scale":
        return row.get("series") if row.get("series") == "sharded" \
            else "grid"
    if mode == "elastic":
        return "cell" if row["key"].startswith("elastic@") else row["key"]
    return row["key"]


def _check_grammar(mode, port_art):
    """The port artifact's meta keys and each row kind's keys are the JAX
    artifact's (plus PORT_EXTRA)."""
    jax_art = _jax_artifact(mode)
    assert set(port_art) == set(jax_art)
    want = {}
    for r in jax_art["rows"]:
        want.setdefault(_row_kind(mode, r), set()).update(r)
    got = {}
    for r in port_art["rows"]:
        got.setdefault(_row_kind(mode, r), set()).update(r)
    assert set(got) == set(want)
    for kind, keys in got.items():
        assert keys == want[kind] | PORT_EXTRA.get(kind, set()), kind


# ------------------------------------------------------------- markdown

@pytest.mark.parametrize("mode", ["scale", "elastic", "recovery"])
def test_markdown_is_the_jax_markdown(mode):
    art = _jax_artifact(mode)
    fn = f"{mode}_markdown"
    assert getattr(port_loadgen, fn)(art) == getattr(jax_loadgen, fn)(art)
    assert getattr(port_loadgen, fn)({}) == getattr(jax_loadgen, fn)({})


def test_trajectory_compression_is_the_jax_one():
    rng = random.Random(4)
    hist, n = [], 1
    for i in range(157):
        act = rng.choice(["hold"] * 8 + ["up", "down"])
        n = max(1, n + {"up": 1, "down": -1}.get(act, 0))
        hist.append({"t": 10.0 + i * 0.05, "replicas": n,
                     "load_per_replica": rng.random() * 6,
                     "queued": rng.randrange(9), "action": act})
    for keep in (1, 10, 25):
        assert port_loadgen._compress_trajectory(hist, keep) == \
            jax_loadgen._compress_trajectory(hist, keep)
    assert port_loadgen._compress_trajectory([]) == []


@pytest.mark.parametrize("count", [1, 5, 64, 1000, 1023])
def test_diurnal_plan_is_the_jax_plan(count):
    assert port_loadgen.DIURNAL_EPOCHS == jax_loadgen.DIURNAL_EPOCHS
    assert port_loadgen.DIURNAL_TIME_FACTOR == \
        jax_loadgen.DIURNAL_TIME_FACTOR
    assert port_loadgen.diurnal_epoch_counts(count) == \
        jax_loadgen.diurnal_epoch_counts(count)
    kw = dict(count=count, methods=("SUM", "MAX"), dtype="int",
              n_choices=(64, 128), rate_rps=300.0, process="diurnal",
              burst=8, slo="std")
    a = jax_loadgen._stamp_idem(jax_loadgen.plan_workload(9, **kw), "x-")
    b = port_loadgen._stamp_idem(port_loadgen.plan_workload(9, **kw), "x-")
    assert [(o, r.method, r.n, r.seed, r.slo, r.idem_key) for o, r in a] \
        == [(o, r.method, r.n, r.seed, r.slo, r.idem_key) for o, r in b]


def test_recovery_evidence_is_the_jax_audit(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    with open(path + ".1", "w") as f:
        f.write(json.dumps({"ev": "serve.coalesce", "batch": 0,
                            "idems": ["kr-0", "kr-1"]}) + "\n")
    with open(path, "w") as f:
        for r in ({"ev": "serve.coalesce", "batch": 1,
                   "idems": ["kr-1", "x-9"]},
                  {"ev": "serve.dedup", "idem": "kr-2"},
                  {"ev": "serve.dedup", "idem": "x-2"},
                  {"ev": "adopt.done", "adopted": 2, "reaped": 0,
                   "wall_s": 0.3}):
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")
    for prefix in ("kr-", "x-", "none-"):
        assert port_loadgen._recovery_evidence(path, prefix) == \
            jax_loadgen._recovery_evidence(path, prefix)
    assert port_loadgen._recovery_evidence(path, "kr-")["duplicates"] == 1
    assert port_loadgen._recovery_evidence(None, "kr-") == \
        jax_loadgen._recovery_evidence(None, "kr-")


def test_sharded_evidence_is_the_jax_read(tmp_path):
    path = tmp_path / "l.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in (
        {"ev": "collective.select", "algorithm": "all_reduce",
         "wire_factor": 1.75, "quantized": False, "ranks": 8},
        {"ev": "serve.verify", "devices": 8}, {"ev": "serve.verify"})))
    assert port_loadgen._sharded_evidence(str(path)) == \
        jax_loadgen._sharded_evidence(str(path))


# ------------------------------------------------------------- the modes

SCALE = ["--scale", "--scale-clients=8,16", "--replicas=2", "--n=2048",
         "--devices=8", "--sharded-n=600000", "--platform=cpu"]


def test_scale_writes_the_jax_grammar_and_resumes(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setenv("TPU_REDUCTIONS_SHARD_THRESHOLD_BYTES", "1048576")
    out = tmp_path / "serving_scale.json"
    assert port_loadgen.main(SCALE + [f"--out={out}"]) == 0
    art = json.loads(out.read_text())
    assert art["complete"] is True
    _check_grammar("scale", art)
    keys = [r["key"] for r in art["rows"]]
    assert keys == [f"{s}@{c}@poisson" for c in (8, 16)
                    for s in ("sequential", "coalesced", "router2")] + [
        "coalesced@16@bursty", "router2@16@bursty", "sharded"]
    for r in art["rows"][:-1]:
        assert r["ok"] == r["requests"] == r["clients"]
    sh = art["rows"][-1]
    assert sh["status"] == "ok" and sh["devices"] == 8 and sh["algorithm"]
    assert sh["cards"] == 1          # the CPU: one device
    assert set(sh["seconds"]) == {"fill", "fold", "fold_cards", "gather",
                                  "combine", "verify"}
    assert "device-parallel sharded row" in capsys.readouterr().out
    # an incomplete artifact resumes every row it holds
    art["complete"] = False
    art["rows"] = art["rows"][:4]
    out.write_text(json.dumps(art))
    assert port_loadgen.main(SCALE + [f"--out={out}"]) == 0
    err = capsys.readouterr().err
    assert err.count("resumed from prior artifact") == 4
    assert json.loads(out.read_text())["rows"][:4] == art["rows"]


def test_scale_through_a_modeled_round_trip(tmp_path):
    out = tmp_path / "s.json"
    assert port_loadgen.main([
        "--scale", "--scale-clients=8", "--replicas=2", "--n=2048",
        "--skip-sharded", "--launch-latency-ms=5", "--platform=cpu",
        f"--out={out}"]) == 0
    art = json.loads(out.read_text())
    assert art["launch_latency_ms"] == 5.0
    seq = next(r for r in art["rows"] if r["series"] == "sequential")
    assert seq["ok"] == 8 and seq["p50_ms"] >= 5.0


def test_elastic_writes_the_jax_grammar(tmp_path, capsys):
    out = tmp_path / "serving_elastic.json"
    assert port_loadgen.main([
        "--elastic", "--scale-clients=16,32", "--elastic-seconds=1",
        "--n=2048", "--devices=8", "--platform=cpu",
        f"--out={out}"]) == 0
    art = json.loads(out.read_text())
    _check_grammar("elastic", art)
    rows = {r["key"]: r for r in art["rows"]}
    assert set(rows) == {"elastic@16@diurnal", "elastic@32@diurnal",
                         "drain", "kill"}
    for r in art["rows"]:
        assert r["ok"] == r["requests"]
    dr, kl = rows["drain"], rows["kill"]
    assert dr["victim_shed"] == 0
    assert dr["reshard"]["ok"] is True and dr["reshard"]["ranks"] == 8
    assert dr["reshard"]["measured_mem_factor"] <= \
        dr["reshard"]["mem_factor"]
    assert kl["reshard"] is None
    assert "drain-vs-kill" in capsys.readouterr().out


def test_recovery_writes_the_jax_grammar(tmp_path):
    out = tmp_path / "serving_recovery.json"
    assert port_loadgen.main([
        "--recovery", "--recovery-requests=12", "--crash-after=4",
        "--n=4096", "--platform=cpu", f"--out={out}"]) == 0
    art = json.loads(out.read_text())
    _check_grammar("recovery", art)
    rows = {r["key"]: r for r in art["rows"]}
    kr = rows["kill_router"]
    assert kr["ok"] == kr["requests"] == 12
    assert kr["duplicates"] == 0 and kr["adopted"] == 2
    assert kr["router_exit"] == 86
    assert len(kr["routers"]) == 2 and "adopted" in kr["routers"][1]
    for key in ("kill_replica", "drain"):
        assert rows[key]["ok"] == 12 and rows[key]["duplicates"] == 0
    assert rows["drain"]["shed"] == 0


def test_sweep_journal_reaps_what_a_journal_names(tmp_path):
    import subprocess
    import sys
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        path = tmp_path / "j.json"
        path.write_text(json.dumps({"replicas": {
            "replica-0": {"state": "up", "pid": child.pid, "port": 1}}}))
        port_loadgen._sweep_journal(str(path), grace_s=5.0)
        assert child.wait(timeout=30) is not None
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    port_loadgen._sweep_journal(str(tmp_path / "missing.json"))


def test_regen_folds_the_fleet_artifacts(tmp_path):
    from tpu_reductions_torch.bench import regen
    (tmp_path / "shmoo.json").write_text("[]")
    for mode in ("scale", "elastic", "recovery"):
        (tmp_path / f"serving_{mode}.json").write_text(
            json.dumps(_jax_artifact(mode)))
    logs = []
    assert regen.regenerate(tmp_path, log=logs.append)
    md = (tmp_path / "report.md").read_text()
    for mode in ("scale", "elastic", "recovery"):
        assert getattr(port_loadgen, f"{mode}_markdown")(
            _jax_artifact(mode)) in md
        assert any(f"serving_{mode}" in line for line in logs)
