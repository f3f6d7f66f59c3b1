"""The headline row's candidate, its snapshot, and the double scoreboard.

The port's own counterpart of what bench/firstrow.py takes from the JAX
package's root bench.py (`CANDIDATES`, `_write_snapshot`,
`_on_flagship_geometry`, `_maybe_double_spots`):

- `CANDIDATES`: (backend, kernel, threads) of the int32 SUM n = 2^24
  headline row, the crowned one first. They come from the port's own
  chained race on the H100 (bench.autotune; PERF.md §5), not from the
  TPU's race: see docs/PORT.md.
- `write_snapshot`: the verified headline value with its provenance,
  next to firstrow's `--out` (never at the repository root, where the
  JAX package keeps its TPU snapshot).
- `on_flagship_geometry`: a snapshot is taken only on the card, at the
  headline n.
- `double_spots`: f64 SUM/MIN/MAX at the flagship grid's contract
  (bench/sweep.FLAGSHIP_GRID) through the pair kernel (`--f64=dd`, the
  JAX package's f64 route), each row persisted as it lands.
"""

from __future__ import annotations

import datetime
import sys
from typing import Optional

import torch

from tpu_reductions_torch.bench.report import REFERENCE_SINGLE_GPU
from tpu_reductions_torch.utils.jsonio import atomic_json_dump

# the reference GPU's int32 SUM at n = 2^24: the headline's yardstick
BASELINE_GBPS = REFERENCE_SINGLE_GPU[("INT", "SUM")]
HEADLINE_N = 1 << 24

# The tops of the chained int32 SUM n = 2^24 race on an H100 (bench.autotune
# --grid=default --comparator; PERF.md §5): k6 at threads 2048 first, the
# runners-up of the other kernels, and the torch comparator.
CANDIDATES = (
    ("cuda", 6, 2048),
    ("cuda", 6, 256),
    ("cuda", 8, 128),
    ("cuda", 7, 1024),
    ("torch", 6, 256),
)


def on_flagship_geometry(n: int, platform: str) -> bool:
    """The card, at the headline n: the gate of the snapshot.
    The counterpart of bench.py:163."""
    return platform == "gpu" and torch.cuda.is_available() \
        and n == HEADLINE_N


def write_snapshot(path: str, payload: dict, per_candidate: dict,
                   device: str) -> None:
    """Persist a fresh verified headline value with its capture time, the
    device's name and the candidates' rows as provenance.
    The counterpart of bench.py:89."""
    captured = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")
    atomic_json_dump(path, {
        **payload, "captured": captured, "device": device,
        "timing": ("chained slope (ops/chain.py: one CUDA graph a trip), "
                   "median, every PASSED row verified against the host "
                   "oracle"),
        "provenance": {"candidates": per_candidate}})


def double_spots(path: str, *, n: Optional[int] = None,
                 iterations: Optional[int] = None, reps: Optional[int] = None,
                 platform: str = "gpu") -> None:
    """f64 SUM/MIN/MAX chained spots through the pair kernel into `path`,
    each row persisted as it lands; defaults from FLAGSHIP_GRID, so that
    the rows can be seeded into the flagship grid's cache.
    The counterpart of bench.py:371."""
    from tpu_reductions_torch.bench.resume import Checkpoint
    from tpu_reductions_torch.bench.spot import run_spots
    from tpu_reductions_torch.bench.sweep import FLAGSHIP_GRID
    from tpu_reductions_torch.config import ReduceConfig
    from tpu_reductions_torch.utils.logging import BenchLogger

    n = FLAGSHIP_GRID["n"] if n is None else n
    iterations = (FLAGSHIP_GRID["iterations"] if iterations is None
                  else iterations)
    reps = FLAGSHIP_GRID["chain_reps"] if reps is None else reps
    print("# doubles: f64 SUM/MIN/MAX chained spots (pair kernel, "
          "flagship-grid contract)", file=sys.stderr)
    base = ReduceConfig(method="SUM", dtype="float64", n=n,
                        threads=FLAGSHIP_GRID["threads"],
                        kernel=FLAGSHIP_GRID["kernel"],
                        iterations=iterations, warmup=2, timing="chained",
                        chain_reps=reps, stat="median", f64="dd",
                        platform=platform, log_file=None)
    reference = {m: REFERENCE_SINGLE_GPU[("DOUBLE", m)]
                 for m in ("SUM", "MIN", "MAX")}
    ck = Checkpoint(path, {"n": base.n, "timing": "chained",
                           "stat": "median", "f64": "dd",
                           "reference": reference},
                    key_fn=lambda r: r.get("method"))

    def persist(row):
        print(f"# doubles: {row['method']} "
              f"{row['gbps'] if row['gbps'] is not None else 'n/a'}"
              f" GB/s [{row['status']}]", file=sys.stderr)
        ck.add(row)

    run_spots(base, ["SUM", "MIN", "MAX"],
              logger=BenchLogger(None, None, console=sys.stderr),
              on_result=persist)
    ck.finalize()
    print(f"# doubles: wrote {path}", file=sys.stderr)
