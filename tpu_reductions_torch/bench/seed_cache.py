"""Seed the flagship grid's cache from spot artifacts.

The port's copy of tpu_reductions/bench/seed_cache.py:1. A spot scoreboard
(the JAX package's bench/spot.py; the port's waits for its port) may hold
PASSED rows measured at exactly the flagship grid's contract
(sweep.FLAGSHIP_GRID, checked by the same cell_matches as sweep_all's
resume). This writes such a row into an open repeat slot of the grid's
cache, so the next regeneration (bench/regen.py) or sweep_all resume
counts it. Only rows that already are flagship-grid measurements move,
each records where it came from, a live grid cell is never overwritten,
and a row never seeds twice.

Offline: touches no device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path
from typing import List, Optional

from tpu_reductions_torch.bench.resume import load_cell, store_cell
from tpu_reductions_torch.bench.sweep import FLAGSHIP_GRID, cell_matches


def _same_measurement(a: dict, b: dict) -> bool:
    """The same physical measurement, wherever it sits: compare rows
    minus slot/provenance bookkeeping (the duplicate guard that makes
    re-seeding idempotent)."""
    strip = ("repeat", "seeded_from", "provenance")
    return ({k: v for k, v in a.items() if k not in strip}
            == {k: v for k, v in b.items() if k not in strip})


def seed(spot_path: str | Path, grid_dir: str | Path,
         grid: Optional[dict] = None, log=print) -> List[Path]:
    """Seed grid_dir/raw_output from one spot artifact; returns the
    cell files written. Rows off the grid contract are skipped (a
    kernel-7 spot never passes for a kernel-6 cell); live cells are
    never overwritten, only empty slots and other-configuration cells.
    The counterpart of tpu_reductions/bench/seed_cache.py:47."""
    grid = dict(grid or FLAGSHIP_GRID)
    contract = {k: grid[k] for k in ("n", "backend", "kernel", "threads",
                                     "iterations", "timing",
                                     "chain_reps")}
    try:
        data = json.loads(Path(spot_path).read_text())
    except (OSError, ValueError) as e:
        log(f"seed_cache: {spot_path}: unreadable ({e}); skipped")
        return []
    raw = Path(grid_dir) / "raw_output"
    raw.mkdir(parents=True, exist_ok=True)
    seeded: List[Path] = []
    for row in data.get("rows", []):
        method, dtype = row.get("method"), row.get("dtype")
        if dtype not in grid["dtypes"] or method not in grid["methods"]:
            continue
        if not cell_matches(row, method=method, dtype=dtype, **contract):
            continue
        gbps = row.get("gbps")
        if not isinstance(gbps, (int, float)) or not math.isfinite(gbps):
            # a PASSED row whose gbps serialized as null (to_dict nulls
            # non-finite rates) has no rate to average, and would break
            # this log line and sweep_all's resume log
            log(f"seed_cache: {dtype} {method}: non-finite gbps; skipped")
            continue
        slots = [raw / f"run-{dtype}-{method}-{rep}.json"
                 for rep in range(grid["repeats"])]
        current = {f: load_cell(f) for f in slots if f.exists()}
        if any(_same_measurement(row, cur) for cur in current.values()):
            continue   # this exact measurement is already in the cache
        for rep, f in enumerate(slots):
            cur = current.get(f)
            if cur is not None and cell_matches(
                    row=cur, method=method, dtype=dtype, **contract):
                continue   # a live grid cell: never overwrite
            out = dict(row)
            out["repeat"] = rep
            out["seeded_from"] = os.path.basename(str(spot_path))
            store_cell(f, out)   # atomic: a kill cannot truncate a cell
            seeded.append(f)
            log(f"seed_cache: {dtype} {method} "
                f"{row.get('gbps', float('nan')):.4f} GB/s -> {f.name}")
            break
        else:
            log(f"seed_cache: {dtype} {method}: all {grid['repeats']} "
                "slots hold live cells; nothing to seed")
    return seeded


def main(argv=None) -> int:
    """CLI: move flagship-contract spot rows into the grid's cache.

        python -m tpu_reductions_torch.bench.seed_cache SPOT.json ... --grid-dir OUT/single_chip
    The counterpart of tpu_reductions/bench/seed_cache.py:111.
    """
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.seed_cache",
        description="Seed the flagship grid's resume cache from spot "
                    "artifacts (offline; missing artifacts are skipped)")
    p.add_argument("spots", nargs="+",
                   help="spot JSON artifacts (a spot run's --out files)")
    p.add_argument("--grid-dir", required=True,
                   help="flagship grid dir (e.g. OUT/single_chip of "
                        "bench.experiment)")
    ns = p.parse_args(argv)
    total = []
    for s in ns.spots:
        if not os.path.exists(s):
            print(f"seed_cache: {s}: absent; skipped", file=sys.stderr)
            continue
        total.extend(seed(s, ns.grid_dir))
    print(f"seed_cache: seeded {len(total)} cell(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
