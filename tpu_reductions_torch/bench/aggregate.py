"""raw -> collected -> averaged results (the reference's getAvgs.sh).

The port's copy of tpu_reductions/bench/aggregate.py:1. The reference
concatenates its per-job stdout files (mpi/raw_output/stdout-*) into
collected.txt, averages GB/s per (DATATYPE, OP, node count) with awk and
bc (mpi/getAvgs.sh), and writes mpi/results/${DATATYPE}_${OP}.txt for
makePlots.gp. The same stages as functions, with the same
`DATATYPE OP NODES GB/sec` rows (reduce.c:67-69).
"""

from __future__ import annotations

import json
import math
import statistics
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from tpu_reductions_torch.utils.logging import (COLLECTIVE_HEADER,
                                                COLLECTIVE_ROW_TEMPLATE)

Key = Tuple[str, str, int]   # (DATATYPE, OP, ranks)

_DTYPE_NAMES = {"int32": "INT", "float64": "DOUBLE", "float32": "FLOAT",
                "bfloat16": "BF16"}


def collect(raw_dir: str | Path, out_file: str | Path | None = None
            ) -> List[str]:
    """Concatenate raw run outputs into data rows — the
    `cat stdout-* > collected.txt` step (getAvgs.sh:7-10). Accepts both
    row-format .txt and the sweep's JSON-lines .json files.
    """
    rows: List[str] = []
    for f in sorted(Path(raw_dir).glob("*")):
        if f.suffix == ".json":
            for line in f.read_text().splitlines():
                if not line.strip():
                    continue
                d = json.loads(line)
                if d.get("status", "PASSED") != "PASSED":
                    # failed/waived runs carry no trustworthy throughput —
                    # exclude them from the published averages
                    continue
                ranks = d.get("ranks", 1)
                dt = _DTYPE_NAMES.get(d["dtype"], d["dtype"].upper())
                gbps = d.get("reference_gbps", d.get("gbps"))
                if gbps is None or not math.isfinite(gbps):
                    # Python's json.loads accepts NaN/Infinity tokens;
                    # a non-finite rate must not poison the averages
                    continue
                rows.append(COLLECTIVE_ROW_TEMPLATE.format(
                    dtype=dt, op=d["method"], ranks=ranks, gbps=gbps))
        else:
            for line in f.read_text().splitlines():
                parts = line.split()
                # the full row grammar, strictly: DATATYPE OP NODES
                # GB/sec with integer NODES and a PARSEABLE rate. A
                # free-form log dropped into raw_output/ must not
                # fabricate rows or crash average() on float('done').
                if len(parts) == 4 and parts[2].isdigit():
                    try:
                        rate = float(parts[3])
                    except ValueError:
                        continue
                    if not math.isfinite(rate):
                        # 'nan'/'inf'/'Infinity' parse as floats but
                        # would propagate into average() and the tables
                        continue
                    rows.append(line.strip())
    if out_file:
        Path(out_file).write_text("\n".join(rows) + "\n")
    return rows


def average(rows: Iterable[str]) -> Dict[Key, float]:
    """Mean GB/s per (DATATYPE, OP, ranks) — the awk+bc loop of
    getAvgs.sh:8-11."""
    groups: Dict[Key, list] = defaultdict(list)
    for row in rows:
        dt, op, ranks, gbps = row.split()
        groups[(dt, op, int(ranks))].append(float(gbps))
    return {k: statistics.fmean(v) for k, v in groups.items()}


def write_results(avgs: Dict[Key, float], out_dir: str | Path) -> List[Path]:
    """Emit results/${DATATYPE}_${OP}.txt files (getAvgs.sh:12-14 analog):
    one averaged `DATATYPE OP NODES GB/sec` row per rank count, ascending,
    under the header row the downstream plotters expect."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    by_file: Dict[Tuple[str, str], list] = defaultdict(list)
    for (dt, op, ranks), gbps in sorted(avgs.items()):
        by_file[(dt, op)].append((ranks, gbps))
    for (dt, op), series in by_file.items():
        path = out / f"{dt}_{op}.txt"
        lines = [COLLECTIVE_HEADER]
        lines += [COLLECTIVE_ROW_TEMPLATE.format(dtype=dt, op=op,
                                                 ranks=ranks, gbps=gbps)
                  for ranks, gbps in sorted(series)]
        path.write_text("\n".join(lines) + "\n")
        written.append(path)
    return written


def pipeline(raw_dir: str | Path, out_dir: str | Path) -> List[Path]:
    """raw_output/ -> collected.txt -> results/*.txt in one call.
    The counterpart of tpu_reductions/bench/aggregate.py:111."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = collect(raw_dir, out / "collected.txt")
    return write_results(average(rows), out / "results")
