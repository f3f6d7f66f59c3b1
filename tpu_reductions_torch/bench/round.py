"""The round metric: one JSON line, the headline row's best verified GB/s.

The counterpart of the JAX package's root bench.py (its `main`): int32
SUM at n = 2^24, the reference's flagship configuration
(reduction.cpp:665; 90.8413 GB/s on the reference GPU, mpi/CUdata.txt:6),
raced over bench/headline.CANDIDATES one at a time, chained (one CUDA
graph a trip, ops/chain.py), median of 7 slope reps over a span of
`--iterations`, every row verified against the host oracle. It prints
exactly one JSON line on stdout,

    {"metric": ..., "value": GB/s, "unit": "GB/s", "vs_baseline": x}

with vs_baseline = value / 90.8413, both rounded to 4 places. On the
card at the headline n the line is printed as soon as a candidate
verifies, and the snapshot (`--out`/snapshot.json) is rewritten after
every candidate; elsewhere the line is printed when the race ends. The
per-candidate rows, their spread and any note go to stderr. After the
first candidate, on the card at the headline n, the f64 SUM/MIN/MAX
scoreboard runs through the pair kernel (headline.double_spots, into
`--out`/doubles.json), best-effort as in the JAX package.

Nothing is written outside `--out` (default out/round/) and the
preflight's health file: the repository root's BENCH_*.json are the JAX
package's TPU artifacts. On the card the race starts only after the
JAX script's device probe, here utils/preflight.run_preflight: the first
device call in a subprocess under a timeout. A verdict other than LIVE
prints, on stderr, whether the probe hung or failed to initialize, and
exits 1 with no metric line. The JAX script's outage fallback, which
prints a committed snapshot in place of a run, is left out: it would
hide the card (docs/PORT.md).

CLI:
    python -m tpu_reductions_torch.bench.round [--n=16777216]
        [--iterations=256] [--platform=gpu|cpu] [--out=out/round]

Exit 0 when a candidate PASSED, else 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

# the device probe's timeout: a torch import and a CUDA context take
# seconds, a hang takes forever
DEVICE_PROBE_TIMEOUT_S = 60.0


def device_probe(timeout_s: float = DEVICE_PROBE_TIMEOUT_S) -> str | None:
    """The card's first contact in a preflight subprocess
    (utils/preflight.py), so a hung device cannot hang this process: None
    when LIVE, else one line saying whether the probe hung or failed to
    initialize, with its detail.
    The counterpart of bench.py:37."""
    from tpu_reductions_torch.utils import preflight
    record = preflight.run_preflight(timeout_s=timeout_s)
    if record["verdict"] == preflight.LIVE:
        return None
    kind = ("hang" if "hung" in record["detail"]
            else "init failure (not a hang)")
    return (f"device probe {record['verdict']}: {kind}: "
            f"{record['detail']}")


def _label(n: int) -> str:
    return f"2^{n.bit_length() - 1}" if n & (n - 1) == 0 else str(n)


def payload(results: list, n: int) -> dict:
    """The metric line: the best PASSED candidate's GB/s (0.0 if none).
    The line that bench.py:174 prints."""
    from tpu_reductions_torch.bench.headline import BASELINE_GBPS
    value = round(max((r.gbps for r in results if r.passed), default=0.0),
                  4)
    return {"metric": f"single-chip int32 SUM reduction bandwidth, "
                      f"n={_label(n)}",
            "value": value, "unit": "GB/s",
            "vs_baseline": round(value / BASELINE_GBPS, 4)}


def provenance(done) -> dict:
    """Per candidate: its GB/s, status and, from its positive slopes, the
    spread [slowest, fastest] of its reps.
    The per-candidate rows of bench.py:174."""
    out = {}
    for cfg, res in done:
        entry = {"gbps": (round(res.gbps, 1) if math.isfinite(res.gbps)
                          else None),
                 "status": res.status.name}
        pos = [s for s in (res.slope_samples_s or [])
               if isinstance(s, (int, float)) and s > 0]
        if pos:
            entry["gbps_spread"] = [round(cfg.nbytes / max(pos) / 1e9, 1),
                                    round(cfg.nbytes / min(pos) / 1e9, 1)]
        out[f"{cfg.backend} k{cfg.kernel} threads={cfg.threads}"] = entry
    return out


def main(argv=None) -> int:
    """CLI: the round metric (module docstring).
    The counterpart of bench.py:174."""
    from tpu_reductions_torch.config import PLATFORMS

    p = argparse.ArgumentParser(prog="tpu_reductions_torch.bench.round",
                                description="The round metric: one JSON "
                                            "line")
    p.add_argument("--n", type=int, default=1 << 24)
    p.add_argument("--iterations", type=int, default=256,
                   help="chained span")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS)
    p.add_argument("--out", type=str, default=os.path.join("out", "round"))
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.round", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    if ns.n <= 0:
        p.error("--n must be positive")
    from tpu_reductions_torch import device as device_mod
    device_mod.resolve(ns.platform)      # no card: raises, no probe
    if ns.platform == "gpu":
        problem = device_probe()
        if problem is not None:
            print(f"# round: {problem}; no metric", file=sys.stderr)
            return 1

    from tpu_reductions_torch.bench import headline
    from tpu_reductions_torch.bench.driver import run_benchmark_batch
    from tpu_reductions_torch.config import ReduceConfig
    from tpu_reductions_torch.utils.logging import BenchLogger

    dev = device_mod.resolve(ns.platform)
    base = ReduceConfig(method="SUM", dtype="int32", n=ns.n,
                        iterations=ns.iterations, warmup=2, stat="median",
                        timing="chained", chain_reps=7,
                        platform=ns.platform, log_file=None)
    cfgs = [dataclasses.replace(base, backend=b, kernel=k, threads=t)
            for b, k, t in headline.CANDIDATES]
    logger = BenchLogger(None, None, console=sys.stderr)
    flagship = headline.on_flagship_geometry(ns.n, ns.platform)
    snapshot = os.path.join(ns.out, "snapshot.json")

    results = []
    printed = None

    def print_once():
        nonlocal printed
        if printed is None:
            line = payload(results, ns.n)
            print(json.dumps(line), flush=True)
            printed = line["value"]

    for i, cfg in enumerate(cfgs):
        res = run_benchmark_batch([cfg], logger=logger)[0]
        results.append(res)
        print(f"# {cfg.backend} k{cfg.kernel} threads={cfg.threads}: "
              f"{res.gbps:.1f} GB/s [{res.status.name}]", file=sys.stderr)
        if flagship and any(r.passed for r in results):
            # a verified value at the flagship: on disk and on stdout now
            snap = payload(results, ns.n)
            if i < len(cfgs) - 1:
                snap["partial"] = True      # the race is still running
            os.makedirs(ns.out, exist_ok=True)
            headline.write_snapshot(snapshot, snap,
                                    provenance(zip(cfgs, results)),
                                    device_mod.name(dev))
            print_once()
        if flagship and i == 0:
            try:   # best-effort, as in the JAX package
                headline.double_spots(os.path.join(ns.out, "doubles.json"),
                                      platform=ns.platform)
            except Exception as e:
                print(f"# doubles spot failed (non-fatal): "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
    print_once()
    print(f"# spread: {json.dumps(provenance(zip(cfgs, results)))}",
          file=sys.stderr)
    best = payload(results, ns.n)["value"]
    if best > printed:
        print(f"# NOTE: headline line printed {printed} GB/s (first "
              f"verified candidate); the completed race's best is {best} "
              f"GB/s; {snapshot} is authoritative", file=sys.stderr)
    passed = [(c, r) for c, r in zip(cfgs, results) if r.passed]
    if passed:
        top_cfg, top = max(passed, key=lambda cr: cr[1].gbps)
        if top_cfg.backend == "torch":
            print(f"# NOTE: the torch comparator won this run "
                  f"({top.gbps:.1f} GB/s); the line carries it, as the "
                  f"best PASSED candidate", file=sys.stderr)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
