"""Find a cell's files by name, run it once, and print the result line.

`BENCHMARK.json` names each cell's configuration, traffic mix and
metrics. Everything else is found by name, so a new cell, configuration
or metric is a new file and a new entry, never an edit:

  configs/<config>.json        the configuration; its `driver` names the
                               window's driver, the module
                               portbench.drivers.<driver>
  reference/<config>.py        the configuration's plain reference
  traffic/<traffic>.json       the mix's parameters, read by the driver
  end_to_end/<metric>.py       `read(window) -> number`
  metrics/<metric>.py          `read(slice) -> number or None`, and
                               optionally `lines(slice) -> [str]`

An end-to-end metric with a `workloads` list is reported in those cells;
a per-layer metric in the cells its `workloads` lists, or without the
key in every cell that reports the metric it `moves`.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent
SPEC_NAME = "BENCHMARK.json"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpu_reductions"})


@dataclasses.dataclass
class Cell:
    """One workload of the spec with its files resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path

    def module(self, folder: str, name: str):
        return load_module(self.bench_dir, folder, name)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back from one run of a cell.

    `window`: seconds, bytes, latencies_s and ops of the measured window;
    `window_start`: its start on the wall clock (time.time()); `checks`:
    name -> [number compared, its limit]; `slice`: the traced slice or
    None; `forbidden`: modules of FORBIDDEN that a worker process held."""

    window_start: float
    window: dict
    checks: dict
    attempted: int
    failed: int
    kind: str
    count: int
    memory_peak_bytes: int
    slice: object = None
    forbidden: list = dataclasses.field(default_factory=list)
    lines: list = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0
                and all(v <= lim for v, lim in self.checks.values()))


def load_spec(root: Path = BENCH_DIR.parent) -> dict:
    with open(root / SPEC_NAME) as f:
        return json.load(f)


def load_json(bench_dir: Path, folder: str, name: str) -> dict:
    with open(bench_dir / folder / f"{name}.json") as f:
        return json.load(f)


def load_module(bench_dir: Path, folder: str, name: str):
    """The module of `<folder>/<name>.py` (names may hold dots and
    dashes), loaded once per path."""
    path = bench_dir / folder / f"{name}.py"
    key = ("portbench._" + folder + "."
           + name.replace(".", "_").replace("-", "_"))
    if key in sys.modules and sys.modules[key].__file__ == str(path):
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def resolve(spec: dict, cell_name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `cell_name` of the spec, its files loaded."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r}; the spec has "
                       f"{sorted(cells)}")
    w = cells[cell_name]
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell_name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name=cell_name, chips=int(w["chips"]),
                config=load_json(bench_dir, "configs", w["config"]),
                traffic=load_json(bench_dir, "traffic", w["traffic"]),
                end_to_end=e2e, per_layer=layer, bench_dir=bench_dir)


def load_entry(entry: str):
    """The function a "module:function" path names."""
    module, name = entry.split(":")
    return getattr(importlib.import_module(module), name)


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    """The FORBIDDEN top-level names among this process's modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             platform: str = "gpu", entry: Optional[str] = None) -> Outcome:
    """One run of the cell through its driver. `entry`, a
    "module:function" path, replaces the program's entry (the control and
    the planted faults); None runs the program."""
    driver = importlib.import_module(
        f"portbench.drivers.{cell.config['driver']}")
    return driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                      platform=platform, entry=entry)


def result_line(cell: Cell, out: Outcome, trace: bool, t0: float) -> dict:
    """The contract's last line; `checks` comes last."""
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = out.window_start - t0
            else:
                value = cell.module("end_to_end", m["name"]).read(out.window)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif out.slice is not None:
        for m in cell.per_layer:
            value = cell.module("metrics", m["name"]).read(out.slice)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": out.kind, "count": out.count,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.slice is not None:
        cards = out.slice.cards
        device["busy_s"] = sum(c.busy_s() for c in cards) / len(cards)
        device["window_s"] = sum(c.length_s for c in cards) / len(cards)
        from portbench.tracing import breakdown
        line["breakdown"] = breakdown(cards[0])
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def detail_lines(cell: Cell, out: Outcome, trace: bool) -> list:
    lines = list(out.lines)
    if trace and out.slice is not None:
        for m in cell.per_layer:
            mod = cell.module("metrics", m["name"])
            if hasattr(mod, "lines"):
                lines += mod.lines(out.slice)
    return lines


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python3 -m portbench",
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.time() if t0 is None else t0
    args = parse(argv)
    cell = resolve(load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; this benchmark measures the "
              "card and has no CPU run", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, this host "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = sorted(set(forbidden_modules()) | set(out.forbidden))
    if found:
        print(f"portbench: the run loaded {found}, which the benchmark of "
              f"the port must not", file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace), t0)
    for text in detail_lines(cell, out, bool(args.trace)):
        print(text)
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
