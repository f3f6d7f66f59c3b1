"""Every instrument that launches through the port's execution core
(exec/core.run), run on the CPU with the flight recorder armed: each
surface shows a clean join (one exec.plan, exec.launch and ok exec.done
for every launch, the done event in the plan's span), and the rows are
the ones the instrument gives when each launch is the plain call it was
before the core (`plain_core`)."""

import io
import json
from collections import Counter

import numpy as np
import pytest

from tpu_reductions_torch.bench import (autotune, collective_driver,
                                        family_spot, firstrow, smoke, spot,
                                        sweep)
from tpu_reductions_torch.config import CollectiveConfig, ReduceConfig
from tpu_reductions_torch.exec import core as exec_core
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils.logging import BenchLogger
from torch_routes import fixed_slopes, numpy_oracle  # noqa: F401


@pytest.fixture
def recorder(tmp_path, monkeypatch):
    """The port's ledger armed at a fresh file; calling it returns the
    lines so far."""
    monkeypatch.delenv("TPU_REDUCTIONS_FAULTS", raising=False)
    path = tmp_path / "ledger.jsonl"
    ledger.arm(path)

    def read():
        return [json.loads(ln) for ln in path.read_text().splitlines()]
    yield read
    ledger.disarm()


def plain_core(monkeypatch):
    """Each launch a plain call of its builder, as before the core."""
    monkeypatch.setattr(exec_core, "run",
                        lambda plan: plan.builder(
                            exec_core.LaunchContext(plan)))


def _join(lines: list) -> Counter:
    """Launches per surface; fails unless every exec.plan has its
    exec.launch and an ok exec.done in its own span."""
    plans, launches, dones = Counter(), Counter(), Counter()
    span_of = {}
    for r in lines:
        if r["ev"] == "exec.plan":
            plans[r["surface"]] += 1
            span_of.setdefault(r["surface"], []).append(r["span"])
        elif r["ev"] == "exec.launch":
            launches[r["surface"]] += 1
        elif r["ev"] == "exec.done":
            assert r["ok"] is True, r
            assert r["span"] in span_of[r["surface"]]
            dones[r["surface"]] += 1
    assert plans == launches == dones
    return plans


def _quiet():
    return BenchLogger(None, None, console=io.StringIO())


def _keys(rows, keys):
    return [{k: r.get(k) for k in keys} for r in rows]


SPOT_KEYS = ("method", "dtype", "n", "status", "device_result", "gbps",
             "kernel")


def test_spot_rows_through_the_core(recorder, monkeypatch, fixed_slopes,
                                    numpy_oracle):
    base = ReduceConfig(n=16384, iterations=8, chain_reps=2,
                        timing="chained", platform="cpu", log_file=None)
    rows = spot.run_spots(base, ["SUM", "MIN", "MAX"], logger=_quiet())
    assert _join(recorder()) == {"spot/sum": 1, "spot/min": 1,
                                 "spot/max": 1}
    plain_core(monkeypatch)
    before = spot.run_spots(base, ["SUM", "MIN", "MAX"], logger=_quiet())
    assert _keys(rows, SPOT_KEYS) == _keys(before, SPOT_KEYS)
    assert {r["status"] for r in rows} == {"PASSED"}


def test_smoke_cases_through_the_core(recorder, monkeypatch, fixed_slopes):
    n = 512 * 128 * 8
    rows = smoke.run_smoke(n=n, platform="cpu", logger=_quiet())
    got = _join(recorder())
    assert got == Counter(r["surface"] for r in rows)
    assert sum(got.values()) == len(smoke.CASES) + len(smoke.FAMILY_CASES)
    plain_core(monkeypatch)
    before = smoke.run_smoke(n=n, platform="cpu", logger=_quiet())
    keys = ("name", "surface", "status", "ok", "error")
    assert _keys(rows, keys) == _keys(before, keys)


def test_firstrow_through_the_core(recorder, monkeypatch, tmp_path,
                                   fixed_slopes, numpy_oracle):
    argv = ["--platform=cpu", "--n=65536", "--iterations=8",
            "--chainreps=2", "--skip-doubles"]
    assert firstrow.main(argv + [f"--out={tmp_path / 'a.json'}"]) == 0
    assert _join(recorder()) == {"firstrow": 1}
    plain_core(monkeypatch)
    assert firstrow.main(argv + [f"--out={tmp_path / 'b.json'}"]) == 0
    a, b = (json.loads((tmp_path / f).read_text())["row"]
            for f in ("a.json", "b.json"))
    assert _keys([a], SPOT_KEYS) == _keys([b], SPOT_KEYS)


def test_family_spot_and_its_serving_rows(recorder, monkeypatch,
                                          numpy_oracle):
    kw = dict(n=2048, segments=8, seed=0, reps=1, serve_n=4096,
              platform="cpu", logger=_quiet())
    rows = family_spot.run_family_spot(**kw)
    got = _join(recorder())
    cells = [c for c in family_spot.family_cells() if c[0] == "cell"]
    assert sum(v for s, v in got.items()
               if not s.startswith("family-")) == len(cells)
    # one coalesced launch a serving row
    assert {s for s in got if s.startswith("family-")} == {
        "family-scan/xla-cumsum", "family-seg/segsum",
        "family-argk/argmax"}
    serves = [r for r in rows if r["kind"] == "serve"]
    assert [(r["method"], r["ok_count"], r["status"]) for r in serves] == [
        ("SCAN", 3, "PASSED"), ("SEGSUM", 3, "PASSED"),
        ("ARGMAX", 3, "PASSED")]
    plain_core(monkeypatch)
    before = family_spot.run_family_spot(**kw)
    keys = ("kind", "method", "dtype", "impl", "n", "status", "max_err",
            "ok_count")
    assert _keys(rows, keys) == _keys(before, keys)


def test_autotune_candidates_through_the_core(recorder, monkeypatch,
                                              fixed_slopes, numpy_oracle):
    base = ReduceConfig(method="SUM", dtype="int32", n=16384, iterations=4,
                        chain_reps=2, timing="chained", platform="cpu",
                        log_file=None)
    grid = [(6, 128, 64), (8, 128, 64)]
    pairs = autotune.autotune(base, grid, logger=_quiet(), comparator=True)
    got = _join(recorder())
    assert sum(got.values()) == len(pairs) == 3
    assert {"autotune/k6", "autotune/k8"} <= set(got)
    plain_core(monkeypatch)
    before = autotune.autotune(base, grid, logger=_quiet(), comparator=True)
    assert [(c.kernel, c.backend, r.status.name, r.gbps)
            for c, r in pairs] == [(c.kernel, c.backend, r.status.name,
                                    r.gbps) for c, r in before]


def test_sweep_cells_through_the_core(recorder, monkeypatch, fixed_slopes,
                                      numpy_oracle):
    cfg = ReduceConfig(method="SUM", dtype="int32", timing="chained",
                       iterations=4, chain_reps=2, platform="cpu",
                       log_file=None)
    res = sweep.run_shmoo(cfg, min_pow=10, max_pow=12, logger=_quiet())
    assert _join(recorder()) == {"sweep-cell": 3}
    plain_core(monkeypatch)
    before = sweep.run_shmoo(cfg, min_pow=10, max_pow=12, logger=_quiet())
    assert [(r.n, r.status.name, r.gbps) for r in res] == \
        [(r.n, r.status.name, r.gbps) for r in before]


@pytest.mark.parametrize("argv", [
    dict(method="SUM", n=4096, num_devices=8),
    dict(method="MIN", n=4096, num_devices=8, rooted="scatter"),
], ids=["ring", "scatter"])
def test_collective_warmup_through_the_core(recorder, monkeypatch, argv):
    cfg = CollectiveConfig(retries=2, platform="cpu", **argv)
    rows = collective_driver.run_collective_benchmark(cfg, logger=_quiet())
    got = _join(recorder())
    assert list(got) == [f"collective/{rows[0].algorithm}"]
    plain_core(monkeypatch)
    before = collective_driver.run_collective_benchmark(cfg,
                                                        logger=_quiet())
    assert [(r.method, r.dtype, r.ranks, r.status.name, r.algorithm)
            for r in rows] == [(r.method, r.dtype, r.ranks,
                                r.status.name, r.algorithm) for r in before]
    assert {r.status.name for r in rows} <= {"PASSED", "WAIVED"}


def test_reshard_program_through_the_core(recorder, monkeypatch):
    from tpu_reductions_torch import reshard
    src = reshard.ShardingSpec.sharded(4, 2, 0)
    dst = reshard.ShardingSpec.replicated(4, 2)
    shape = (16, 64)
    carried = np.random.default_rng(0).standard_normal(shape).astype(
        np.float32)
    plan = reshard.plan_reshard(src, dst, shape, 4)
    res = reshard.execute_plan(plan, carried, reshard.make_mesh(4, "cpu"),
                               repeats=1)
    assert _join(recorder()) == {"reshard": 1}
    hb = [r for r in recorder() if r["ev"] == "hb.phase"]
    assert {r["phase"] for r in hb} >= {"reshard.step"}
    plain_core(monkeypatch)
    before = reshard.execute_plan(plan, carried,
                                  reshard.make_mesh(4, "cpu"), repeats=1)
    for a, b in zip(res["shards"], before["shards"]):
        assert np.array_equal(a, b)
    assert [s["primitive"] for s in res["steps"]] == \
        [s["primitive"] for s in before["steps"]]
