"""A later change adds a cell, a configuration and a per-layer metric as
files and entries of their own: in a copy of the benchmark, new files
and new entries are found by name, and no file that was there changes."""

import hashlib
import json
import shutil

from portbench import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_are_files_of_their_own(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.BENCH_DIR.parent / harness.SPEC_NAME, tmp_path)
    before = _digests(bench)

    # the new files: a configuration, its reference, a mix and a metric
    cfg = json.loads((bench / "configs" / "sdk_reduction.json").read_text())
    cfg.update(name="sdk_int_only", rows=[["SUM", "int32"], ["MAX", "int32"]])
    (bench / "configs" / "sdk_int_only.json").write_text(json.dumps(cfg))
    (bench / "reference" / "sdk_int_only.py").write_text(
        "from portbench.reference.sdk_reduction import (  # noqa: F401\n"
        "    checks, control_entry, expected, lowered)\n")
    (bench / "traffic" / "awaited-tiny.json").write_text(json.dumps(
        {"n": {"int32": 2048}, "payloads": 2, "warmup_calls": 4,
         "trace_calls": 3, "collect_every": 4}))
    (bench / "metrics" / "calls_in_slice.py").write_text(
        "def read(s):\n    return float(s.ops)\n")

    # and their entries
    spec = json.loads((tmp_path / harness.SPEC_NAME).read_text())
    spec["configs"].append({"name": "sdk_int_only", "source": "https://x",
                            "file": "portbench/configs/sdk_int_only.json",
                            "reduced": [], "why": "int rows only"})
    spec["workloads"].append({"name": "sdk_int_only.awaited-tiny",
                              "config": "sdk_int_only",
                              "traffic": "awaited-tiny", "chips": 1,
                              "why": "a tiny int cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "reduce_gbps":
            m["workloads"].append("sdk_int_only.awaited-tiny")
    spec["per_layer"].append({"name": "calls_in_slice", "unit": "calls",
                              "better": "higher", "source": "program_counter",
                              "layer": "host dispatch",
                              "moves": "reduce_gbps"})
    (tmp_path / harness.SPEC_NAME).write_text(json.dumps(spec))

    after = _digests(bench)
    assert {k: after[k] for k in before} == before

    spec = harness.load_spec(tmp_path)
    cell = harness.resolve(spec, "sdk_int_only.awaited-tiny", bench)
    assert cell.config["name"] == "sdk_int_only"
    assert cell.traffic["n"] == {"int32": 2048}
    assert {m["name"] for m in cell.end_to_end} == {"reduce_gbps", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["calls_in_slice"]
    # the metric without a `workloads` key reaches every cell that reports
    # what it moves
    assert "calls_in_slice" in {m["name"] for m in harness.resolve(
        spec, "sdk_reduction.awaited-2e24", bench).per_layer}

    out = harness.run_cell(cell, 3, 1.0, True, platform="cpu")
    line = harness.result_line(cell, out, True, out.window_start)
    assert line["correct"] is True
    assert line["metrics"]["calls_in_slice"]["value"] == 3.0
