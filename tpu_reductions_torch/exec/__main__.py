"""Decision-table CLI: `python -m tpu_reductions_torch.exec --explain`.

The counterpart of tpu_reductions/exec/__main__.py: the cost oracle
(exec/cost.py) over the same fixed grid of (op, dtype, n, ranks, slack)
cells, one block per axis across its crossover, each decision a JSON row
and an `exec.select` ledger event, then the table. The grid is
deterministic. The oracle reads the port's evidence under
`TPU_REDUCTIONS_EVIDENCE_ROOT` (or --evidence-root) and touches no
device; like every entry point of the port the CLI resolves the card
first, and raises without one unless --platform=cpu is given.

    python -m tpu_reductions_torch.exec --explain [--platform=cpu] \
        [--evidence-root DIR] [--out out/exec_decisions.json]
"""

from __future__ import annotations

import argparse
import sys

from tpu_reductions_torch.exec.cost import CostOracle, Decision, emit_select

# the JAX grid: each block walks one axis across its crossover
_KERNEL_CELLS = [("SUM", "int", 1 << 22), ("SUM", "int", 1 << 24),
                 ("SUM", "int", 1 << 25), ("SUM", "int", 1 << 28),
                 ("MAX", "double", 1 << 23), ("MAX", "double", 1 << 26)]
_TOPOLOGY_CELLS = [(2, 3 * 2), (4, 3 * 4), (16, 3 * 16), (64, 3 * 64),
                   (16, 3 << 20)]
_WIRE_CELLS = [("SUM", "float32", 8, 1 << 24, None),
               ("SUM", "float32", 8, 1 << 24, 1.0),
               ("SUM", "float32", 8, 1 << 24, 0.005),
               ("SUM", "bfloat16", 8, 1 << 24, 0.005),
               ("MIN", "float32", 8, 1 << 24, 0.005)]
_SCAN_CELLS = [("int32", 1 << 24), ("float32", 1 << 20),
               ("float32", 1 << 26)]


def decision_rows(oracle: CostOracle) -> list:
    """The whole grid, evaluated: the artifact's `rows`."""
    rows = []

    def add(decision: Decision, **geometry):
        rows.append({**decision.row(), "geometry": geometry})
        emit_select(decision, **geometry)

    for method, dtype, n in _KERNEL_CELLS:
        add(oracle.pick_kernel(method, dtype, n),
            method=method, dtype=dtype, n=n)
    for k, per_rank in _TOPOLOGY_CELLS:
        add(oracle.pick_topology(k, per_rank),
            devices=k, per_rank_len=per_rank)
    for method, dtype, k, payload, slack in _WIRE_CELLS:
        add(oracle.pick_wire(method, dtype, k, payload, slack),
            method=method, dtype=dtype, devices=k,
            payload_bytes=payload, slack_s=slack)
    for dtype, n in _SCAN_CELLS:
        add(oracle.pick_scan(dtype, n),
            method="SCAN", dtype=dtype, n=n)
    return rows


def _table(rows: list) -> str:
    out = ["axis      choice    geometry                                "
           "reason",
           "-" * 78]
    for r in rows:
        geo = " ".join(f"{k}={v}" for k, v in r["geometry"].items())
        out.append(f"{r['axis']:<9} {r['choice']:<9} {geo:<39} "
                   f"{r['reason']}")
    return "\n".join(out)


def flipped_axes(rows: list) -> list:
    """The axes on which two decisions chose differently."""
    return sorted({r["axis"] for r in rows for s in rows
                   if r["axis"] == s["axis"]
                   and r["choice"] != s["choice"]})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_reductions_torch.exec",
        description="cost-oracle decision table")
    p.add_argument("--explain", action="store_true",
                   help="print the decision table (the only mode)")
    p.add_argument("--out", default=None,
                   help="write the JSON artifact here")
    p.add_argument("--platform", default="gpu", choices=("gpu", "cpu"))
    p.add_argument("--evidence-root", default=None,
                   help="evidence root (default "
                        "TPU_REDUCTIONS_EVIDENCE_ROOT, else the working "
                        "directory)")
    ns = p.parse_args(argv)
    from tpu_reductions_torch import device as device_mod
    device_mod.resolve(ns.platform)
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("exec", argv=list(argv) if argv else sys.argv[1:])

    oracle = CostOracle(root=ns.evidence_root)
    rows = decision_rows(oracle)
    print(_table(rows))
    flips = flipped_axes(rows)
    print(f"\n{len(rows)} decisions; regime flips on axes: "
          f"{', '.join(flips) if flips else 'NONE (evidence missing?)'}")
    if ns.out:
        from tpu_reductions_torch.utils.jsonio import atomic_json_dump
        doc = {"kind": "exec-decisions", "version": 1, "complete": True,
               "platform": ns.platform, "rows": rows}
        atomic_json_dump(ns.out, doc)
        print(f"wrote {ns.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
