"""BENCHMARK.json against the benchmark contract, and the last line's
schema from a run of a cell on the CPU at a small size."""

import json
import math
import re

import pytest

from portbench import harness
from portbench.tests import full_spec

# the committed spec, and with the pending cells merged in: both must
# keep the contract, so that a pending cell is added by its entries alone
SPECS = {"benchmark": harness.load_spec(), "with_pending": full_spec()}
SPEC = SPECS["benchmark"]
each_spec = pytest.mark.parametrize("spec", SPECS.values(), ids=SPECS)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    assert isinstance(text, str) and 1 <= len(text) <= 200
    assert "\n" not in text and "\t" not in text


@each_spec
def test_top_level_keys_command_paths_and_length(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["command"]) <= 32
    for word in spec["command"]:
        _line(word)
        assert not word.startswith("/") and ".." not in word
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert (harness.BENCH_DIR.parent / p).is_dir()
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(spec, indent=1)) <= 64 * 1024


@each_spec
def test_configs_are_files_under_paths_and_each_used(spec):
    used = {w["config"] for w in spec["workloads"]}
    names = [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    files = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        _line(c["source"])
        _line(c["why"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((harness.BENCH_DIR.parent / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] == []
    assert used == set(names)


@each_spec
def test_cells(spec):
    cells = spec["workloads"]
    names = [w["name"] for w in cells]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        _line(w["why"])
        assert (harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json") \
            .is_file()


@each_spec
def test_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        if m["name"] != "setup_s":
            assert (harness.BENCH_DIR / "end_to_end"
                    / f"{m['name']}.py").is_file()
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    assert 1 <= len(spec["per_layer"]) <= 128
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        _line(m["layer"])
        layers.setdefault(m["layer"], []).append(m["name"])
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    names = list(e2e) + [m["name"] for m in spec["per_layer"]]
    assert len(names) == len(set(names))
    assert set(layers) <= {"host dispatch", "kernel passes", "collective",
                           "device"}


@pytest.mark.parametrize("cell", sorted(w["name"] for w in
                                        SPECS["with_pending"]["workloads"]))
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = harness.resolve(SPECS["with_pending"], cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_last_line_schema_from_a_cpu_run():
    cell = harness.resolve(SPEC, "sdk_reduction.awaited-2e24")
    cell.traffic = dict(cell.traffic, n={"int32": 4096, "float64": 4096},
                        trace_calls=20, collect_every=8)
    for trace in (False, True):
        out = harness.run_cell(cell, 2**31 + 5, 0.3, trace, platform="cpu")
        line = harness.result_line(cell, out, trace, out.window_start - 1.0)
        assert list(line)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] > 0
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        if trace:
            assert set(line["device"]) >= {"busy_s", "window_s"}
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        else:
            assert set(line["metrics"]) == {m["name"]
                                            for m in cell.end_to_end}
            assert line["metrics"]["setup_s"]["value"] == 1.0
        for m in line["metrics"].values():
            assert math.isfinite(m["value"]) and UNIT.match(m["unit"])
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
        assert json.loads(json.dumps(line)) == line
