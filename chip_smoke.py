#!/usr/bin/env python3
"""Chip smoke test of tpu_reductions_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

or, on a machine with several, the rank axis across cards alone
(`[multicard]`, below; it ends with the same last line):

    python3 chip_smoke.py --phase=multicard

1. Builds the hand-written kernels (tpu_reductions_torch/csrc/*.cu, one
   nvcc per source, all started together) and prints the build time and
   the register report.
2. Holds every kernel against its plain PyTorch version on the card:
   k6 and k7 for SUM/MIN/MAX x int32/float32/float64/bfloat16 at
   n = 2^24 and at a ragged n = 2^24 + 37; k8 and k10 on the same pairs
   at --threads 256 and 2048, k10 at depths 1, 2, 4, 8 and the deepest
   ring, and at depth 4 once more, which must all give k8's bits; k9 for
   SUM x float32/float64/bfloat16, and its column sums of uniform [0, 1)
   data against float64 ones (its precision mode); dd, the f64 pair
   kernel, for SUM/MIN/MAX at the same sizes and --threads (and 8 and 200
   at the ragged size), on the benchmark payload and on a full-range SUM
   (uniform(-1, 1) x 1e300 against math.fsum), its fused pair finish
   bit-equal to the torch halving tree over its accumulator, and the
   same bits twice in a row and on two streams at once; k8 too must give
   the same bits twice in a row and on two streams at once. After k8 and
   k10, probes where the bf16 payload is read from (bench/passes.py
   l2_probe).
   Times each kernel, its plain version and one PyTorch reduction of the
   same staged tensor with CUDA events, at int32 SUM n = 2^24 (k9: float32
   SUM; dd: float64 SUM, its library call torch.sum of the native f64
   tensor, its reduce the fused finish and `tree_ms` the torch tree it
   replaced). k6, k7 and k9 must give the same bits when called again on
   the same tensor.
   Then profiles one k6 call, one k7 chain and one k10 call at depths 1
   and 4 at int32 SUM n = 2^24, one k8 call on int32/float32/float64/
   bfloat16 SUM and bfloat16 MAX (at int32 SUM it must be one CUDA
   launch), one k9 call at float32 SUM, and dd and the f64 pair route at
   float64 SUM, with
   torch.profiler (tpu_reductions_torch/bench/passes.py): each CUDA
   kernel's name, launches and device time, each launch in order (k6's
   two passes, the chain's passes and finish), and the idle time between
   them; and prints the cluster occupancy and the k6/k7/k8/k10/k9/dd
   plans there.
3. Drives the port's main path, its CLI `main()`, for the benchmark rows
   below, each to a verified PASSED row (or the WAIVED it must give), and
   checks through the wrappers' launch counters that each row went
   through its kernel.
4. Drives the kernel race, `tpu_reductions_torch.bench.autotune`, twice
   at full width: every kernel on float32 SUM at n = 2^24, and k10's
   depth race on int32 SUM at n = 2^26. Each must exit 0 with a kernel row
   as its best and no FAILED kernel candidate; the counters show which
   kernels each race launched.
5. Drives the streaming pipeline: the CLI's `--stream` on four payloads
   up to 2 GiB, and `tpu_reductions_torch.bench.stream --serial-baseline`,
   each to PASSED, beside the rate of one pinned 256 MiB host-to-device
   copy (a stream is bound by the host link, not by device memory).
6. The native oracle: the library must build on the card's host; prints
   the host time of its filler and Kahan oracle beside the numpy route's
   at n = 2^24 (int32, float32), and each main-path row's payload and
   oracle route. (bench/host.py compares the routes at 2^30.)
7. The rest of the CLI, each path with the counters set to 0 just before
   it: `[chain]`, the chain as one CUDA graph (ops/chain.py): k6, k8 and
   the f64 pair route give the plain loop's bits at k = 1 and 17 and
   count 1 + k launches, and the chained int32 SUM row at n = 2^24
   through k6 takes at most 1.2 x (k6's reduce + the fold) an iteration,
   both timed with CUDA events in the phase; `[spot]`, the spot CLI on
   int32 and on the f64 pair route, SUM/MIN/MAX at 2^24, every row
   PASSED; `[smoke]`, the smoke CLI, every case PASSED or WAIVED, its k8,
   k9, k10 and dd cases launching their kernels; `[family]`, the
   family-spot CLI at 2^24 with 64 segments, every cell verified and
   PASSED; `[firstrow]` into out/smoke_firstrow, its row, snapshot and
   three doubles PASSED; `[warm]`, the build cold and warm and every
   surface's first call against a warm one, none failed;
   `--shmoo` over 2^10..2^28 on int32 SUM and chained float32 SUM,
   every row PASSED; `--check` on k6-k10 and `--f64=dd` at n = 2^24, each
   OK, and once with k6's plain version on a wrong op, which must FAIL
   its row; `--trace` of k6 into out/smoke_trace_k6 and of a chained k6
   row (its chain's graph) into out/smoke_trace_chain, each trace naming
   k6's launches; int32 SUM at n = 2^30 (4 GiB), staged in chunks, and
   float32 SUM at 2^30 under TPU_REDUCTIONS_STAGE_CHUNK_BYTES=64 MiB,
   each with the host time of its native fill, staging and oracle;
   `[collective]`, the collective driver (bench/collective_driver.py)
   with its k ranks as rows of one tensor on the card: the reduce.c grid
   (int32 and float64 x MAX/MIN/SUM, k = 8, n = 2^27) periter and
   chained, int32 SUM/MIN at k = 8 with --rooted scatter and root and
   MIN scatter at k = 6, the f64 pair route at 2^26 (the dd ring at k = 8,
   its naive fallback at k = 3, the key-pair MIN and MAX), and the rank
   ladder k = 2..1024 at 2^26, every row PASSED with its algorithm's label
   and printed beside its bound; and the chained int32 SUM slope at k = 8
   within 1.2 x (one collective call + the fold), both timed with CUDA
   events; `[round]`, the round metric (bench/round.py) at its defaults,
   one JSON line with value > 0 and vs_baseline = value / 90.8413;
   `[quant]`, the collective driver under --quantized at k = 8 and
   n = 2^27 (the f64 dd planes at 2^26): SUM over float32, bfloat16 and
   float64 at 4/8/16 bits, MIN and MAX over float32/float64 at 8/16,
   chained, float32 SUM q8 periter too, every row PASSED within its
   declared bound (MIN/MAX exact) with its label and printed beside its
   bound, and the CLI at n = 2^27 - 8, which must say it fell back to the
   exact psum and pass; `[rank_scaling]`, bench/rank_scaling.py into
   out/smoke_rank_scaling: the sweep of int32 and float64 x MAX/MIN/SUM at
   2^26 over ranks 2, 8, 64, 256, 1024 (one retry), the averages and
   figures, the amortisation probe at 1024 ranks, the quantized curve
   (102 cells) and the reshard curve (42 cells) at 2^24 over ranks 2..64,
   every row PASSED, each reshard row's measured memory within its
   declared factor and the permute pairs' wire under the naive
   program's; each stage's seconds printed; `[exec]`, the cost oracle's
   decision table (`python -m tpu_reductions_torch.exec --explain`) over
   this run's own evidence (the first race, the stream probe, warm's
   ledger, the family grid, the rank sweep and the quantized curve,
   gathered under out/smoke_evidence): all 19 decisions, the kernel axis
   priced from the race, the float scan cells from the family grid, the
   topology axis from the rank sweep; `[serve]`, the serving path
   (tpu_reductions_torch/serve/) on the card: the closed-loop load
   generator with 8 clients x 32 requests of SUM/MIN/MAX, coalesced and
   sequential, at int32 n = 2^16 and at int32 and float32 n = 2^22, every
   response ok and verified, coalesced batching above 1, the engine's
   batches equal to its executor's serve-bucket launches, each row
   printed with its rate, p50/p99, mean batch, launches and the
   executor's seconds of fill, stack, copy, reduce and verify; then one
   engine serving a float64 request, the family's three serving cells at
   2^22 and one oversized int32 request of 2^28 (1 GiB) through the
   stream route, all ok; then `python -m tpu_reductions_torch.serve` in a
   process of its own on a port from the OS, driven by the load
   generator's --connect, every response ok; `[fleet]`, the replica fleet
   (serve/router.py, journal.py, autoscale.py and the executor's shard
   route, docs/PORT.md "The fleet on one card") into out/smoke_fleet:
   the load generator's --scale at --devices=8 --replicas=4 over 64, 256
   and 1024 open-loop clients (every series' requests resolved ok; the
   sharded row of 160,000,000 int32 ok over 8 ranks on every card of the
   host, `cards` 1 on one, with its algorithm and its seconds of fill,
   fold, gather, combine and verify), --elastic
   --plan=diurnal --devices=8 (the replica count rises and falls, the
   drain sheds nothing where the kill sheds, the drain's reshard verified
   within its declared memory), --recovery --recovery-requests=48
   --crash-after=16 with its router and replica children on the card
   (every key settles ok once, no duplicate device execution across the
   router's death or the drain, both live children adopted), then
   `python -m tpu_reductions_torch.serve.router --replicas=2` in a
   process of its own driven by --connect (256 responses, all ok); and
   then no process of the phase may be alive, nor among the card's
   compute processes (nvidia-smi --query-compute-apps); `[resilience]`,
   into out/smoke_resilience with one ledger, each CLI in a process of
   its own: the preflight (utils/preflight.py) must find the card LIVE
   and prints its seconds; the scheduler (`python -m
   tpu_reductions_torch.sched`) must run four card tasks (smoke at 2^19,
   spot int32 2^24, the calibration ladder utils/calibrate.py --ladder
   at float32 2^24 and 2^26, warm --only=nvcc,k6,dd) to a complete plan,
   and the ladder's five times a rung and its verdict are printed; then
   a plan whose second task is the hang, the main CLI's int32 SUM 2^24 row
   through k6 with the heartbeat's marks frozen by
   TPU_REDUCTIONS_FAULTS, a 2 s deadline and a 0.5 s watchdog interval,
   must exit 4 with that task's `watchdog.exit` event and phase in the
   ledger and the plan's state incomplete, and, rerun without the
   fault, resume and pick only the two tasks left, the same row passing
   watched; then the stuck kernel: the same row, chained, with the spin
   fault (csrc/fault.cu, 20 s) on its first timed trip, must exit 4 with
   a `watchdog.exit` (code 4, its phase) at most the deadline plus two
   watchdog intervals after its `fault.fire`, its process gone, a fresh
   preflight LIVE and the row then PASSED in a fresh process, each figure
   printed; no process of the phase may be alive; then the ledger's
   analysis: every session's timeline buckets sum to its recorded
   seconds within 1%, the exit-4 stall lands in `stalled`,
   the Chrome trace names a process for every session, the critical
   path's shares are printed, and the compile ledger holds the build's
   cold and warm rows, which the scheduler's priors read as warm.
   Then the flagship experiment, `tpu_reductions_torch.bench.experiment`,
   into out/smoke_experiment: the n = 2^24 grid (float64 and int32 x
   SUM/MIN/MAX, 3 repeats, 18 cells through k6), the chained SUM curves
   (bfloat16 2^10..2^30, float64 ..2^28, int32 ..2^30), the roofline, the
   report and the PDF (or its skip note). Every cell must be PASSED and
   cached, averages.json must hold the 6 (dtype, op) averages, no
   HBM-bound row may read above 1.05 of the roof; prints the averages
   beside the reference GPU's, each curve's peak, N_1/2 and L2->HBM
   cliff, and the experiment's host seconds.
   `[multicard]`: with one card it prints that it did not run and why
   (1 card); with 2 or more, P = min(4, cards): `nvidia-smi topo -m`
   and the cards' names and power limits, the collective CLI itself in P
   processes (int32 SUM at k = 2P, n = 2^27: every process exits 0, rank
   0's placement note, rows, NVLink shares and PASSED), then in P workers
   of bench/multicard.py over NCCL the reduce.c grid at k = P and k = 2P
   (int32 and float64 x MAX/MIN/SUM, n = 2^27, periter and chained),
   SUM and MIN scattered and rooted at k = 2P, the pair route at 2^26 (dd
   SUM, key MIN/MAX, periter and chained) and float32 SUM on the 8-bit
   quantized ring, each beside its one-card twin (the same k and n in
   this process on card 0) with the ratio of their times; a row's
   periter and chained timings share one payload, warm-up and oracle,
   in the workers and in the twin: every row PASSED with its label in
   every process and in the twin, the same bits for every int32 and
   MIN/MAX row and the ring paths, a float SUM through psum within
   registry.tolerance of the twin; on a chained row each process's
   captured chain (NCCL inside the graph) gives the scalar of the same
   chain run one by one, and its scalar is the twin's (same bits, or
   within registry.tolerance for float SUM through psum); no process of
   the phase alive afterwards. Then the sharded serving part on the C = P
   cards (serve/executor.run_sharded over the host's cards): int32 SUM,
   MIN and MAX, float32 SUM, bfloat16 SUM and float32 SUM on the 8-bit
   quantized combine at n = 160,000,000 (the fleet's sharded row), at
   K = C and 2C, each ok with `cards` C and its one-card twin's algorithm
   and bits (the same K with cards=[cuda:0]), printed with its latency,
   fill, each card's fold, gather, combine and verify seconds, the twin's
   latency and the ratio, each partial's card before the gather, each
   card's chunks and how its partials reached cuda:0; then `python -m
   tpu_reductions_torch.serve --devices=2C` in a process of its own,
   whose answers to an oversized int32 SUM and float32 SUM must be ok
   with `cards` C and a `serve.shard` event each; that process gone
   afterwards. The part launches no kernel of the repository. Last, the
   ladder part: bench.rank_scaling across the P cards (one process a
   card, spawned once; each rung's k ranks on min(k, P) cards in
   contiguous blocks): the sweep at n = 2^26, int32 and float64 x
   MAX/MIN/SUM, one retry, over ranks 2, 4, 8, 64 and 1024, the
   amortisation probe at 1024, and the quantized and reshard curves at
   2^24 over ranks 2, 4 and 8, then the same at --cards=1 on cuda:0 as
   its twin: every row PASSED in both, 51 quant and 21 reshard cells in
   each, every row with one card's bits (int32, MIN/MAX, the quantized
   rings, the reshard programs that only move data) or within
   registry.tolerance (float64 SUM through psum, partial_to_row), each
   reshard row's accounted memory factor within its declared one, the
   k = 2 rung on two cards, no worker alive; each rung printed with its
   ms, GB/s, busbw a card against NVLink, the twin's ms and the ratio.
   It launches no kernel of the repository either.
   Last, `[lint]`: the port lint (`python -m tpu_reductions_torch.lint
   tpu_reductions_torch chip_smoke.py --format=json`, a process of its own
   on a machine without jax) with its fact cache cold and then warm; both
   passes must exit 0 with no finding of any rule (RED006 included,
   LINT_RED006_PINNED = 0); prints each pass's seconds. It launches no
   kernel.
8. Prints the card's name and power limit, a `kernels` JSON line, and as
   the last line `{"ok": true, "device": {...}}`.

Any disagreement, failed row or missing launch raises, and the script
exits non-zero without the last line; so it does when no CUDA device is
available or the package is missing.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpu_reductions_torch.bench import passes
from tpu_reductions_torch.bench.passes import (DEPTHS, MXU_DTYPES, N, bits,
                                               device_ms)
from tpu_reductions_torch.ops.chain import CARD_BYTES_PER_S

SIZES = (N, N + 37)
DTYPES = ("int32", "float32", "float64", "bfloat16")
METHODS = ("SUM", "MIN", "MAX")
# H100 SXM published peaks at 700 W: the device-memory rate (the one
# ops/chain.py sizes chained spans from), and the float32 rate outside the
# tensor cores (the one CUDA-core rate NVIDIA's data sheet gives; a
# reduction does one combine per element on them)
HBM_BYTES_PER_S = CARD_BYTES_PER_S
CORE_OPS_PER_S = 67e12
# float32 additions of one dd_add (two-sum 6, renormalisation 5)
DD_ADD_OPS = 11
KERNELS = ("k6", "k7", "k8", "k9", "k10", "dd")
SOURCES = {"k6": "tpu_reductions_torch/csrc/reduce.cu",
           "k7": "tpu_reductions_torch/csrc/reduce.cu",
           "k8": "tpu_reductions_torch/csrc/accumulate.cu",
           "k9": "tpu_reductions_torch/csrc/mxu.cu",
           "k10": "tpu_reductions_torch/csrc/accumulate.cu",
           "dd": "tpu_reductions_torch/csrc/pair.cu"}
REPLACES = {"k6": "tpu_reductions/ops/pallas_reduce.py:390",
            "k7": "tpu_reductions/ops/pallas_reduce.py:404",
            "k8": "tpu_reductions/ops/pallas_reduce.py:227",
            "k9": "tpu_reductions/ops/pallas_reduce.py:240",
            "k10": "tpu_reductions/ops/pallas_reduce.py:338",
            "dd": "tpu_reductions/ops/dd_reduce.py:250"}
PERIOD_THREADS = (256, 2048)      # k8/k10: the default and largest tile
# k9's column sums against float64 on uniform data: the rtol the card
# tests hold float SUM to (bf16 data, float32 accumulator: 1e-2)
MXU_RTOL = {"float32": 1e-6, "float64": 1e-12, "bfloat16": 1e-2}

# The main path: the benchmark CLI rows, the kernel each must launch (None:
# none), and the exit code it must give (0 PASSED, 2 WAIVED).
MAIN_ROWS = (
    [([f"--method={m}", f"--type={t}", "--kernel=6"], "k6", 0)
     for m in METHODS for t in ("int", "float", "double")]
    + [([f"--method={m}", "--type=int", "--kernel=7"], "k7", 0)
       for m in METHODS]
    + [(["--method=SUM", "--type=int", "--kernel=7", "--cpufinal"], "k7", 0),
       (["--method=SUM", "--type=int", "--timing=bulk"], "k6", 0),
       (["--method=SUM", "--type=int", "--timing=chained"], "k6", 0),
       (["--method=SUM", "--type=float", f"--n={1 << 28}",
         "--timing=chained"], "k6", 0),
       (["--method=SUM", "--type=int", "--backend=torch"], None, 0)]
    + [([f"--method={m}", "--type=int", "--kernel=8"], "k8", 0)
       for m in METHODS]
    + [(["--method=SUM", "--type=double", "--kernel=8"], "k8", 0)]
    + [(["--method=SUM", f"--type={t}", "--kernel=9"], "k9", 0)
       for t in ("float", "double", "bfloat16")]
    + [(["--method=MIN", "--type=float", "--kernel=9"], None, 2),
       (["--method=SUM", "--type=int", "--kernel=9"], None, 2)]
    + [(["--method=SUM", "--type=int", "--kernel=10",
         f"--streambuffers={d}"], "k10", 0) for d in DEPTHS]
    + [(["--method=MAX", "--type=float", "--kernel=10"], "k10", 0),
       (["--method=SUM", "--type=float", "--kernel=10", f"--n={1 << 28}",
         "--timing=chained"], "k10", 0)]
    # the f64 pair route, with the JAX driver's gates
    + [([f"--method={m}", "--type=double", "--f64=dd"], "dd", 0)
       for m in METHODS]
    + [(["--method=SUM", "--type=double", "--f64=dd", "--cpufinal"], "dd", 0),
       (["--method=SUM", "--type=double", "--f64=dd", "--timing=chained"],
        "dd", 0),
       (["--method=SUM", "--type=double", "--f64=dd", "--kernel=8"], None, 2),
       (["--method=SUM", "--type=double", "--f64=dd", "--kernel=9"], None, 2),
       (["--method=SUM", "--type=double", "--f64=dd", "--backend=torch"],
        None, 2),
       (["--method=SUM", "--type=int", "--f64=dd"], "k6", 0)])

# The streaming pipeline through the CLI's --stream; each must PASS.
STREAM_ROWS = (
    ["--method=SUM", "--type=int", f"--n={1 << 29}"],       # 8 x 256 MiB
    ["--method=SUM", "--type=double", f"--n={1 << 27}",
     f"--chunk-bytes={16 << 20}"],                           # 32 chunks
    ["--method=MIN", "--type=double", f"--n={1 << 27}"],
    ["--method=MAX", "--type=bfloat16", f"--n={1 << 26}"],
)
# ... and the probe CLI with its serial comparator
STREAM_PROBE = ["--method=SUM", "--type=int", f"--n={1 << 28}",
                f"--chunk-bytes={64 << 20}", "--serial-baseline"]

# The kernel race at full width: (argv, the kernels it must launch).
RACES = (
    (["--method=SUM", "--type=float", f"--n={N}", "--grid=default",
      "--comparator"], ("k6", "k7", "k8", "k9", "k10")),
    (["--method=SUM", "--type=int", f"--n={1 << 26}", "--grid=hbm",
      "--comparator"], ("k6", "k7", "k8", "k10")),
)

# The size sweeps over n = 2^10..2^28: (argv, the kernel every cell
# launches); every row must PASS.
SHMOO_RANGE = (10, 28)
SHMOOS = ((["--method=SUM", "--type=int"], "k6"),
          (["--method=SUM", "--type=float", "--timing=chained"], "k6"))
# the oracle phase's payload size
ORACLE_N = 1 << 24
# --check rows at n = 2^24 and the kernel each must launch
CHECK_ROWS = (
    [(["--method=SUM", "--type=int", f"--kernel={k}"], f"k{k}")
     for k in (6, 7, 8, 10)]
    + [(["--method=SUM", "--type=float", "--kernel=9"], "k9"),
       (["--method=SUM", "--type=double", "--f64=dd"], "dd")])
TRACE_DIR = Path("out") / "smoke_trace_k6"
CHAIN_TRACE_DIR = Path("out") / "smoke_trace_chain"
# [chain]: the graph chain's bits against the plain loop's at these k, and
# the chained int32 SUM row at n = 2^24 through k6 (the grid's span and
# reps), whose slope must stay within CHAIN_RATIO of k6's reduce plus the
# fold, both timed with CUDA events in the same phase
CHAIN_KS = (1, 17)
CHAIN_ROW = dict(method="SUM", dtype="int32", n=N, kernel=6, iterations=256,
                 chain_reps=5, timing="chained", stat="median",
                 log_file=None)
CHAIN_RATIO = 1.2
# [spot]: int32 and the f64 scoreboard (through the pair kernel) at 2^24
SPOT_ROWS = ((["--type=int"], "k6"), (["--type=double", "--f64=dd"], "dd"))
# [family]: the grid at n = 2^24 with 64 segments
FAMILY_N = N
OUT = Path("out")
# 4 GiB rows, over the 512 MiB staging threshold: (argv, environment)
STAGING_N = 1 << 30
STAGING_ROWS = (
    (["--method=SUM", "--type=int", f"--n={STAGING_N}"], {}),
    (["--method=SUM", "--type=float", f"--n={STAGING_N}"],
     {"TPU_REDUCTIONS_STAGE_CHUNK_BYTES": str(64 << 20)}),
)
ROUTE_LINE = re.compile(r"payload and oracle: (\w+)")
SHMOO_LINE = re.compile(r"shmoo (\w+) (\w+) n=(\d+) -> ([\d.]+) GB/s "
                        r"\[(\w+)\]")


def bound_of(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of moving nbytes at
    the memory rate and doing ops at the core rate."""
    by = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
          "operations": 1e3 * ops / CORE_OPS_PER_S}
    bound_by = max(by, key=by.get)
    return {"bound_ms": by[bound_by], "bound_by": bound_by}


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(x2d, out) -> dict:
    """The least time the card could take to fold x2d into out: reading
    x2d and writing out once, one combine per element of x2d."""
    return bound_of(nbytes_of(x2d, out), x2d.numel())


def check_pair(kr, registry, name, got, want, method, dtype, n, depth):
    """Compare a kernel's accumulator with its plain version's. int32 and
    MIN/MAX must be bit-equal (wrapping adds and selections do not depend
    on order). Float SUM adds in another order: each element is held to
    the bound on recursive summation of non-negative terms, twice
    (depth - 1) * unit roundoff * the sum (both sides err by at most
    that), and the finished scalars to registry.tolerance, the benchmark's
    own acceptance rule. Returns the largest absolute difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {method} {dtype} n={n}: shape/dtype "
                             f"{tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    err = (got.double() - want.double()).abs()
    max_err = float(err.max())
    if dtype == "int32" or method != "SUM":
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {method} {dtype} n={n}: not "
                                 f"bit-equal, max |diff| {max_err}")
        return max_err
    unit = torch.finfo(got.dtype).eps / 2
    bound = 2 * (depth - 1) * unit * want.double().abs()
    if bool((err > bound).any()):
        raise AssertionError(f"{name} {method} {dtype} n={n}: element "
                             f"error {max_err} over the summation bound")
    op = registry.get_op(method)
    scalar = abs(float(kr.finish(got, op).double())
                 - float(kr.finish(want, op).double()))
    tol = registry.tolerance(method, dtype, n)
    if scalar > tol:
        raise AssertionError(f"{name} {method} {dtype} n={n}: scalar "
                             f"|diff| {scalar} > tolerance {tol}")
    return max_err


def profile_phase(kr, dd, registry, host_data, dev) -> None:
    """Per-pass device times of k6 and the k7 chain at int32 SUM n = 2^24,
    of k10 at depths 1 and 4 there, of k9 on float32 SUM and of dd and
    the f64 pair route on float64 SUM (bench/passes.py), and the plans
    behind them."""
    sms = kr._sm_count(dev)
    for dtype in DTYPES:
        tm, p, t = kr.choose_tiling(N, 256, 64, dtype)
        sub = kr.sublanes_for(dtype)
        rows = p * t * tm
        torch_dtype = getattr(torch, dtype)
        active = kr._active_clusters(dev, "SUM", torch_dtype)
        k9 = (kr.plan_k9(rows // kr.MXU_SLAB_ROWS[torch_dtype], sms)
              if torch_dtype in kr.MXU_SLAB_ROWS else None)
        k10 = kr.plan_k10(rows // tm, tm, sub, torch_dtype.itemsize, 4, sms)
        print(f"  {dtype}: {sms} SMs, {active} active clusters of "
              f"{kr.CLUSTER} CTAs; k6 {kr.plan_k6(rows, sub, sms, active)}; "
              f"k7 {kr.plan_k7(rows, sub, p, t * tm, sms, active)}; k8 "
              f"{kr.plan_k8(rows // tm, tm, sub, sms)}; k10 at depth 4 "
              f"{k10}; k9 {k9}", flush=True)
    tm, p, t = dd.choose_tiling(N)
    print(f"  float64 pairs: dd {dd.plan_dd(p * t, tm, sms)}", flush=True)
    passes.print_profile(passes.profile_k6_k7(kr, registry, host_data, dev))
    k8 = passes.profile_k8(kr, registry, host_data, dev)
    passes.print_profile(k8)
    if len(k8["k8_int32_SUM"]["launch_us"]) != 1:
        raise AssertionError("k8 at int32 SUM n = 2^24 is not one CUDA "
                             "launch a call")
    passes.print_profile(passes.profile_k9_k10(kr, registry, host_data, dev))
    passes.print_profile(passes.profile_dd(host_data, dev))


def wrappers(kr, dd) -> dict:
    """Each kernel's launch wrapper, which carries its launch count."""
    return {"k6": kr.single_pass_call, "k7": kr.two_pass_call,
            "k8": kr.elementwise_call, "k9": kr.mxu_call,
            "k10": kr.stream_call, "dd": dd.dd_call}


def timing_row(name, method, dtype, n, x2d, out, call, plain, reduce,
               library) -> dict:
    """Device times of a kernel call, its plain version, the whole device
    reduce of the main path (finish included) and one PyTorch reduction
    of the same staged tensor, beside the kernel's bound."""
    row = {"kernel": name, "method": method, "dtype": dtype, "n": n,
           "rows": x2d.shape[0], "ms": device_ms(call),
           "plain_ms": device_ms(plain), "library_ms": device_ms(library),
           "reduce_ms": device_ms(reduce), **bound(x2d, out)}
    print(f"  {name} {method:3s} {dtype:8s} n={n} "
          f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f}"
          f" library_ms={row['library_ms']:.5f} "
          f"reduce_ms={row['reduce_ms']:.5f} "
          f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})", flush=True)
    return row


def k6_k7_vs_plain(kr, registry, host_data, dev, worst, table):
    """k6 and k7 on all 12 pairs at both sizes."""
    for dtype in DTYPES:
        for n in SIZES:
            x = host_data(n, dtype)
            for method in METHODS:
                op = registry.get_op(method)
                tm, p, t = kr.choose_tiling(n, 256, 64, dtype)
                x2d = kr.stage_padded(x, tm, p, t, op, dev)
                sub = kr.sublanes_for(x2d.dtype)
                k6 = kr.single_pass_call(x2d, op)
                k7 = kr.two_pass_call(x2d, op, tm, p, t)
                torch.cuda.synchronize()
                if not (torch.equal(bits(k6), bits(kr.single_pass_call(
                            x2d, op))) and
                        torch.equal(bits(k7), bits(kr.two_pass_call(
                            x2d, op, tm, p, t)))):
                    raise AssertionError(f"k6/k7 {method} {dtype} n={n}: a "
                                         f"second call gave other bits")
                worst["k6"] = max(worst["k6"], check_pair(
                    kr, registry, "k6", k6, kr.single_pass_plain(x2d, op),
                    method, dtype, n, x2d.shape[0] // sub))
                worst["k7"] = max(worst["k7"], check_pair(
                    kr, registry, "k7", k7,
                    kr.two_pass_plain(x2d, op, tm, p, t),
                    method, dtype, n, t * tm // sub))
                if n != N:
                    continue
                table.append(timing_row(
                    "k6", method, dtype, n, x2d, k6,
                    lambda: kr.single_pass_call(x2d, op),
                    lambda: kr.single_pass_plain(x2d, op),
                    lambda: kr.finish(kr.single_pass_call(x2d, op), op),
                    lambda: op.reduce(x2d)))
                # k7's reduce: every pass of the chain, finish included
                table.append(timing_row(
                    "k7", method, dtype, n, x2d, k7,
                    lambda: kr.two_pass_call(x2d, op, tm, p, t),
                    lambda: kr.two_pass_plain(x2d, op, tm, p, t),
                    lambda: kr.finish(kr._multipass_finish(
                        kr.two_pass_call(x2d, op, tm, p, t), op, 256, 64, 1),
                        op),
                    lambda: op.reduce(x2d)))


def check_k8_repeats(kr, name, x2d, op, tm, dev) -> None:
    """Two k8 calls back to back, and two on two streams at once, give
    the first call's bits: every launch leaves its stream's tickets at
    zero, and each stream has its own."""
    want = bits(kr.elementwise_call(x2d, op, tm)).clone()
    got = [kr.elementwise_call(x2d, op, tm) for _ in range(2)]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    for st in streams:
        with torch.cuda.stream(st):
            got.append(kr.elementwise_call(x2d, op, tm))
    torch.cuda.synchronize()
    if not all(torch.equal(bits(g), want) for g in got):
        raise AssertionError(f"{name}: a second call, or one on another "
                             f"stream, gave other bits")


def k8_k10_vs_plain(kr, registry, host_data, dev, worst, table):
    """k8 and k10 on all 12 pairs at both sizes, at the default and the
    largest tile; k10 at every depth of DEPTHS must give the same bits,
    and k8's (the two share their order of adds); k8 the same bits on
    repeat and on two streams at the default tile."""
    for dtype in DTYPES:
        for n in SIZES:
            x = host_data(n, dtype)
            for method in METHODS:
                op = registry.get_op(method)
                for threads in PERIOD_THREADS:
                    tm, p, t = kr.choose_tiling(n, threads, 64, dtype)
                    x2d = kr.stage_padded(x, tm, p, t, op, dev)
                    k8 = kr.elementwise_call(x2d, op, tm)
                    depths = DEPTHS + (kr.stream_max_depth(x2d.dtype),)
                    k10 = {d: kr.stream_call(x2d, op, tm, d) for d in depths}
                    again = kr.stream_call(x2d, op, tm, 4)
                    torch.cuda.synchronize()
                    for d, acc in [*k10.items(), ("4, called again", again)]:
                        if not torch.equal(bits(acc), bits(k8)):
                            raise AssertionError(
                                f"k10 depth {d} {method} {dtype} n={n} "
                                f"tm={tm}: not bit-identical to k8")
                    err = check_pair(kr, registry, "k8", k8,
                                     kr.elementwise_plain(x2d, op, tm),
                                     method, dtype, n, x2d.shape[0] // tm)
                    worst["k8"] = max(worst["k8"], err)
                    worst["k10"] = max(worst["k10"], err)
                    if n != N or threads != 256:
                        continue
                    check_k8_repeats(kr, f"k8 {method} {dtype} n={n}", x2d,
                                     op, tm, dev)
                    table.append(timing_row(
                        "k8", method, dtype, n, x2d, k8,
                        lambda: kr.elementwise_call(x2d, op, tm),
                        lambda: kr.elementwise_plain(x2d, op, tm),
                        lambda: kr.finish(kr.elementwise_call(x2d, op, tm),
                                          op),
                        lambda: op.reduce(x2d)))
                    if method == "SUM" and dtype == "int32":
                        for d in DEPTHS:
                            print(f"  k10 depth {d}: ms="
                                  f"{device_ms(lambda: kr.stream_call(x2d, op, tm, d)):.5f}",
                                  flush=True)
                    table.append(timing_row(
                        "k10", method, dtype, n, x2d, k10[4],
                        lambda: kr.stream_call(x2d, op, tm, 4),
                        lambda: kr.stream_plain(x2d, op, tm),
                        lambda: kr.finish(kr.stream_call(x2d, op, tm, 4),
                                          op),
                        lambda: op.reduce(x2d)))


def k9_vs_plain(kr, registry, host_data, dev, worst, table):
    """k9 on SUM x float32/float64/bfloat16 at both sizes: rows 1-7
    exactly zero, row 0 held as check_pair holds float SUM. Then its
    precision on uniform data, against float64 column sums."""
    op = registry.get_op("SUM")
    for dtype in MXU_DTYPES:
        for n in SIZES:
            x = host_data(n, dtype)
            tm, p, t = kr.choose_tiling(n, 256, 64, dtype)
            x2d = kr.stage_padded(x, tm, p, t, op, dev)
            k9 = kr.mxu_call(x2d, op)
            torch.cuda.synchronize()
            if bool(k9[1:].any()):
                raise AssertionError(f"k9 {dtype} n={n}: rows 1-7 not zero")
            if not torch.equal(bits(k9), bits(kr.mxu_call(x2d, op))):
                raise AssertionError(f"k9 {dtype} n={n}: a second call "
                                     f"gave other bits")
            worst["k9"] = max(worst["k9"], check_pair(
                kr, registry, "k9", k9, kr.mxu_plain(x2d), "SUM", dtype, n,
                x2d.shape[0]))
            if n == N:
                table.append(timing_row(
                    "k9", "SUM", dtype, n, x2d, k9,
                    lambda: kr.mxu_call(x2d, op),
                    lambda: kr.mxu_plain(x2d),
                    lambda: kr.finish(kr.mxu_call(x2d, op), op),
                    lambda: op.reduce(x2d)))
        # the benchmark's payload is small multiples of one constant, whose
        # column sums come out exact; uniform [0, 1) values spread their
        # exponents, where tensor-core additions could lose bits
        x = torch.rand(N, generator=torch.Generator().manual_seed(0),
                       dtype=torch.float64).to(getattr(torch, dtype))
        x2d = kr.stage_padded(x, *kr.choose_tiling(N, 256, 64, dtype), op, dev)
        exact = x2d.double().sum(0)
        errs = {name: float(((row.double() - exact).abs() / exact).max())
                for name, row in (("k9", kr.mxu_call(x2d, op)[0]),
                                  ("plain", kr.mxu_plain(x2d)[0]))}
        print(f"  k9 {dtype} uniform [0, 1) n={N}: largest relative error "
              f"of a column sum against float64: k9 {errs['k9']:.3e}, "
              f"plain {errs['plain']:.3e}", flush=True)
        if errs["k9"] > MXU_RTOL[dtype]:
            raise AssertionError(f"k9 {dtype}: column sums off by "
                                 f"{errs['k9']:.3e} > rtol {MXU_RTOL[dtype]}")


PAIR_UNIT = 2.0**-24      # float32's unit roundoff; a pair's is 4u^2
# the full-range payload's acceptance, tests/test_dd_reduce.py's rule
FULL_RANGE_RTOL = 1e-12


def check_dd(name, got, want, hi2d, lo2d, method, tm, scale_exp) -> float:
    """dd's accumulator against dd_plain's (csrc/pair.cu): MIN/MAX must be
    bit-equal; for SUM, each slot's hi + lo within 2 (d - 1) 4u^2 sum|x| of
    the plain one, d the tiles folded into the slot, sum|x| over its
    elements. Returns the largest |diff| of a slot, in payload units."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: shape/dtype {tuple(g.shape)} "
                                 f"{g.dtype} != {tuple(w.shape)} {w.dtype}")
    if method != "SUM":
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: not bit-equal to dd_plain")
        return 0.0
    d = hi2d.shape[0] // tm
    err = ((got[0].double() + got[1].double())
           - (want[0].double() + want[1].double())).abs()
    mag = (hi2d.double() + lo2d.double()).abs().reshape(d, tm, -1).sum(0)
    if bool((err > 2 * (d - 1) * 4 * PAIR_UNIT**2 * mag).any()):
        raise AssertionError(f"{name}: slot error {float(err.max())} over "
                             "the pair summation bound")
    return math.ldexp(float(err.max()), scale_exp)


# dd's --threads: the default and largest tile at both sizes; the
# smallest and one whose accumulator pads to a power of two at the ragged
DD_THREADS = {N: PERIOD_THREADS, N + 37: PERIOD_THREADS + (8, 200)}


def check_dd_scalar(dd, name, scalar, acc, method) -> None:
    """The fused finish's scalar pair against the torch halving tree over
    the kernel's accumulator, on the card: bit-equal."""
    tree = dd.device_finish_pairs(*acc, method)
    if [bits(v).item() for v in scalar] != [bits(v).item() for v in tree]:
        raise AssertionError(f"{name}: the fused scalar pair "
                             f"{[v.item() for v in scalar]} is not the "
                             f"torch tree's {[v.item() for v in tree]}")


def check_dd_repeats(dd, name, hi2d, lo2d, method, tm, dev) -> None:
    """Two calls back to back, and two on two streams at once, give the
    first call's bits: every launch leaves its stream's tickets at zero,
    and each stream has its own."""
    want = [bits(v).item() for v in dd.dd_scalar_call(hi2d, lo2d, method,
                                                       tm)]
    got = [dd.dd_scalar_call(hi2d, lo2d, method, tm) for _ in range(2)]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    for st in streams:
        with torch.cuda.stream(st):
            got.append(dd.dd_scalar_call(hi2d, lo2d, method, tm))
    torch.cuda.synchronize()
    for pair in got:
        if [bits(v).item() for v in pair] != want:
            raise AssertionError(f"{name}: a second call, or one on another "
                                 f"stream, gave other bits")


def dd_vs_plain(dd, registry, oracle, host_data, dev, worst, table):
    """dd on SUM/MIN/MAX of the float64 payload at both sizes and at TM
    256 and 2048 (and 8 and 200 at the ragged size): the accumulator
    against dd_plain, the fused scalar pair bit-equal to the torch tree
    over the accumulator, the decoded scalar against the oracle, repeat
    bits back to back and on two streams; a full-range SUM against
    math.fsum; and the timing row of float64 SUM at n = 2^24."""
    for n in SIZES:
        x = host_data(n, "float64")
        for method in METHODS:
            want_scalar = oracle.host_reduce(x, method)
            tol = registry.tolerance(method, "float64", n)
            for threads in DD_THREADS[n]:
                hi, lo, (tm, _, _), s = dd.stage_split_padded(
                    x.numpy(), method, threads)
                # redlint: disable=RED020 -- the dd phase's hi plane, n <= 2^24 (64 MiB float32), under the stager's one-shot threshold (config.stage_threshold_bytes, 512 MiB)
                hi2d = torch.from_numpy(hi).to(dev)
                # redlint: disable=RED020 -- the lo plane beside it, the same 64 MiB bound
                lo2d = torch.from_numpy(lo).to(dev)
                got = dd.dd_call(hi2d, lo2d, method, tm)
                scalar = dd.dd_scalar_call(hi2d, lo2d, method, tm)
                want = dd.dd_plain(hi2d, lo2d, method, tm)
                torch.cuda.synchronize()
                name = f"dd {method} n={n} tm={tm}"
                worst["dd"] = max(worst["dd"], check_dd(
                    name, got, want, hi2d, lo2d, method, tm, s))
                check_dd_scalar(dd, name, scalar, got, method)
                value = dd.decode_pair_scalar(*scalar, method, s)
                if abs(float(value) - float(want_scalar)) > tol:
                    raise AssertionError(f"{name}: {value!r} != oracle "
                                         f"{want_scalar!r} (tol {tol})")
                if n != N or threads != 256:
                    continue
                check_dd_repeats(dd, name, hi2d, lo2d, method, tm, dev)
                if method != "SUM":
                    continue
                # redlint: disable=RED020 -- the float64 payload at n = 2^24 (128 MiB) for torch.sum's time, under the stager's one-shot threshold (512 MiB)
                x2d = torch.from_numpy(
                    np.pad(x.numpy(), (0, hi.size - n))).view(hi.shape).to(dev)
                row = {"kernel": "dd", "method": method, "dtype": "float64",
                       "n": n, "rows": hi.shape[0],
                       "ms": device_ms(lambda: dd.dd_call(hi2d, lo2d,
                                                          method, tm)),
                       # a Python loop over the tiles: few trials
                       "plain_ms": device_ms(lambda: dd.dd_plain(
                           hi2d, lo2d, method, tm), calls=1, trials=3),
                       "library_ms": device_ms(lambda: torch.sum(x2d)),
                       # the route's reduce: the kernel with the fused
                       # finish, and the torch tree it replaced
                       "reduce_ms": device_ms(lambda: dd.dd_scalar_call(
                           hi2d, lo2d, method, tm)),
                       "tree_ms": device_ms(lambda: dd.device_finish_pairs(
                           *got, method)),
                       **bound_of(nbytes_of(hi2d, lo2d, *got),
                                  DD_ADD_OPS * hi2d.numel())}
                print(f"  dd SUM float64 n={n} ms={row['ms']:.5f} "
                      f"plain_ms={row['plain_ms']:.5f} "
                      f"library_ms={row['library_ms']:.5f} "
                      f"reduce_ms={row['reduce_ms']:.5f} "
                      f"tree_ms={row['tree_ms']:.5f} "
                      f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})",
                      flush=True)
                table.append(row)
    # full range: the staging scale keeps the float32 planes finite
    x = np.random.default_rng(0).uniform(-1, 1, N) * 1e300
    hi, lo, (tm, _, _), s = dd.stage_split_padded(x, "SUM", 256)
    # redlint: disable=RED020 -- the full-range planes at n = 2^24, 64 MiB each, under the stager's one-shot threshold (512 MiB)
    hi2d, lo2d = torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)
    got = dd.dd_call(hi2d, lo2d, "SUM", tm)
    check_dd("dd full-range SUM", got, dd.dd_plain(hi2d, lo2d, "SUM", tm),
             hi2d, lo2d, "SUM", tm, s)
    scalar = dd.dd_scalar_call(hi2d, lo2d, "SUM", tm)
    check_dd_scalar(dd, "dd full-range SUM", scalar, got, "SUM")
    value = float(dd.decode_pair_scalar(*scalar, "SUM", s))
    exact = math.fsum(x.tolist())
    tol = FULL_RANGE_RTOL * max(abs(exact), float(np.abs(x).max()))
    print(f"  dd full-range SUM n={N}: {value!r} vs fsum {exact!r}, "
          f"|diff| {abs(value - exact):.3e} (tol {tol:.3e})", flush=True)
    if not abs(value - exact) <= tol:
        raise AssertionError("dd full-range SUM off the exact sum")


def run_cli(entry, argv) -> tuple[int, str, float]:
    """Run a CLI `main(argv)` in this process: (exit code, its standard
    output, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = entry(argv)
    return rc, out.getvalue(), time.perf_counter() - t0


# what the port's instruments write in this run, in the layout the cost
# oracle reads (exec/cost._EVIDENCE), for [exec]
EVIDENCE_ROOT = OUT / "smoke_evidence"


def keep_evidence(path, key: str) -> None:
    """Copy one instrument's artifact to its place under EVIDENCE_ROOT."""
    from tpu_reductions_torch.exec.cost import _EVIDENCE
    dst = EVIDENCE_ROOT / _EVIDENCE[key]
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(path, dst)


def drive_main_path(driver, counted, routes) -> dict:
    """Phase 3: every MAIN_ROWS row through the CLI to its status, each
    launching its own kernel and no other; each verified row's payload and
    oracle route goes into `routes`. Returns each kernel's launches over
    the whole main path."""
    for w in counted.values():
        w.launches = 0
    for argv, kernel, want_rc in MAIN_ROWS:
        before = {k: w.launches for k, w in counted.items()}
        rc, text, seconds = run_cli(driver.main, argv + ["--logfile="])
        print(text, end="")
        print(f"  ({seconds:.1f} s)", flush=True)
        status = "PASSED" if want_rc == 0 else "WAIVED"
        if rc != want_rc \
                or f"&&&& tpu_reductions_torch {status}" not in text \
                or (want_rc == 0 and "Reduction, Throughput = " not in text):
            raise AssertionError(f"main path row {argv} did not give "
                                 f"{status} (exit {rc})")
        rose = [k for k, w in counted.items() if w.launches > before[k]]
        if rose != ([kernel] if kernel else []):
            raise AssertionError(f"row {argv} launched {rose}, expected "
                                 f"{kernel}")
        found = ROUTE_LINE.search(text)
        if found:
            routes.append((" ".join(argv), found[1]))
    return {k: w.launches for k, w in counted.items()}


def drive_races(autotune, counted) -> list:
    """Phase 4: each RACES race through the autotune CLI, with the
    counters set to 0 just before it. Returns each race's launches."""
    per_race = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (argv, must) in enumerate(RACES):
            out = Path(tmp) / f"race{i}.json"
            for w in counted.values():
                w.launches = 0
            rc, text, seconds = run_cli(autotune.main,
                                        argv + [f"--out={out}"])
            launches = {k: w.launches for k, w in counted.items()}
            print(text, end="")
            print(f"  ({seconds:.1f} s) launches {launches}", flush=True)
            data = json.loads(out.read_text())
            if i == 0:   # the race the cost oracle prices k6 from
                keep_evidence(out, "autotune")
            failed = [r for r in data["ranked"]
                      if r["backend"] == "cuda" and r["status"] == "FAILED"]
            best = data["best"] or {}
            if rc != 0 or not data["complete"] or best.get("backend") != "cuda":
                raise AssertionError(f"race {argv}: exit {rc}, best {best}")
            if failed:
                raise AssertionError(f"race {argv}: FAILED kernel "
                                     f"candidates {failed}")
            missing = [k for k in must if launches[k] == 0]
            if missing:
                raise AssertionError(f"race {argv} never launched {missing}")
            per_race.append(launches)
    return per_race


STREAM_LINE = re.compile(r"streamed (\d+) chunk\(s\): ([\d.]+) GB/s "
                         r"sustained, ([\d.]+) chunks/s")


def pinned_copy_gbps(dev) -> float:
    """The rate of one pinned 256 MiB host-to-device copy: the bound of
    a stream, whose bytes cross the host link."""
    nbytes = 256 << 20
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = device_ms(lambda: card.copy_(host, non_blocking=True), calls=4,
                   trials=3)
    return nbytes / (ms * 1e-3) / 1e9


def drive_stream(driver, stream_cli, counted, dev) -> dict:
    """Phase 5: the CLI's --stream on STREAM_ROWS and the probe CLI with
    its serial comparator, each to PASSED, with the counters set to 0
    just before. Returns the launches (the stream's fold is PyTorch, as
    the JAX package's is jnp)."""
    copy_gbps = pinned_copy_gbps(dev)
    print(f"  pinned 256 MiB host-to-device copy: {copy_gbps:.4f} GB/s",
          flush=True)
    for w in counted.values():
        w.launches = 0
    for argv in STREAM_ROWS:
        rc, text, seconds = run_cli(driver.main,
                                    argv + ["--stream", "--logfile="])
        print(text, end="")
        found = STREAM_LINE.search(text)
        if rc != 0 or "&&&& tpu_reductions_torch PASSED" not in text \
                or found is None:
            raise AssertionError(f"stream row {argv}: exit {rc}")
        print(f"  ({seconds:.1f} s) chunks={found[1]} gbps_sustained="
              f"{found[2]} chunks_per_s={found[3]} pinned_copy_gbps="
              f"{copy_gbps:.4f}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "stream.json"
        rc, text, seconds = run_cli(stream_cli.main,
                                    STREAM_PROBE + [f"--out={out}"])
        final = next(r for r in json.loads(out.read_text())["rows"]
                     if r.get("final"))
        keep_evidence(out, "stream")
    print(text, end="")
    print(f"  ({seconds:.1f} s) {json.dumps(final)}", flush=True)
    if rc != 0 or final["status"] != "PASSED" \
            or not isinstance(final.get("overlap_efficiency"), float):
        raise AssertionError(f"stream probe {STREAM_PROBE}: exit {rc}")
    return {k: w.launches for k, w in counted.items()}


def host_s(fn) -> tuple:
    """(fn's result, its host seconds)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def oracle_phase(oracle, host_data, routes) -> None:
    """Phase 6: the native library is in use; the host time of its filler
    and Kahan oracle beside the numpy route's at n = 2^24 (at 2^30 the
    [staging] rows time the native route; bench/host.py times both);
    each main-path row's route (bfloat16 rows are numpy in both
    packages)."""
    if not oracle.native_available():
        raise AssertionError("the native oracle did not build on this host")
    for dtype in ("int32", "float32"):
        native, fill_s = host_s(lambda: oracle.native_fill(ORACLE_N, dtype))
        numpy_x, numpy_fill_s = host_s(lambda: host_data(ORACLE_N, dtype))
        value, sum_s = host_s(lambda: oracle.host_reduce(native, "SUM"))
        real = oracle._load
        oracle._load = lambda: None      # the numpy route
        try:
            numpy_value, numpy_sum_s = host_s(
                lambda: oracle.host_reduce(numpy_x, "SUM"))
        finally:
            oracle._load = real
        print(f"  {dtype} n={ORACLE_N}: fill native {fill_s:.4f} s, numpy "
              f"{numpy_fill_s:.4f} s; SUM oracle native {sum_s:.4f} s "
              f"({value!r}), numpy {numpy_sum_s:.4f} s ({numpy_value!r})",
              flush=True)
    for argv, route in routes:
        print(f"  {route:6s} {argv}")
    wrong = [(argv, r) for argv, r in routes
             if r != ("numpy" if "bfloat16" in argv else "native")]
    if wrong:
        raise AssertionError(f"rows off the native route: {wrong}")


def run_row(driver, argv, want_rc=0) -> str:
    """One CLI row to PASSED (or FAILED, exit 1); returns its output."""
    rc, text, seconds = run_cli(driver.main, argv + ["--logfile="])
    print(text, end="")
    print(f"  ({seconds:.1f} s)", flush=True)
    status = {0: "PASSED", 1: "FAILED"}[want_rc]
    if rc != want_rc or f"&&&& tpu_reductions_torch {status}" not in text:
        raise AssertionError(f"row {argv}: exit {rc}, expected {status}")
    return text


def shmoo_path(driver, counted, kr, registry, config, staging) -> None:
    """Each SHMOOS sweep: 19 rows, every one PASSED, through its kernel."""
    lo, hi = SHMOO_RANGE
    for argv, kernel in SHMOOS:
        before = counted[kernel].launches
        cells = SHMOO_LINE.findall(run_row(
            driver, argv + ["--shmoo", f"--shmoo-min={lo}",
                            f"--shmoo-max={hi}"]))
        if len(cells) != hi - lo + 1 or any(c[4] != "PASSED" for c in cells):
            raise AssertionError(f"shmoo {argv}: rows {cells}")
        print("  shmoo GB/s by n: " + ", ".join(
            f"2^{int(c[2]).bit_length() - 1} {c[3]}" for c in cells))
        if counted[kernel].launches == before:
            raise AssertionError(f"shmoo {argv} never launched {kernel}")


def check_path(driver, counted, kr, registry, config, staging) -> None:
    """Each CHECK_ROWS row with --check: OK, PASSED, through its kernel
    alone; then k6's plain version on a wrong op must FAIL the row."""
    for argv, kernel in CHECK_ROWS:
        before = {k: w.launches for k, w in counted.items()}
        if "[OK]" not in run_row(driver, argv + ["--check"]):
            raise AssertionError(f"--check {argv} did not report OK")
        rose = [k for k, w in counted.items() if w.launches > before[k]]
        if rose != [kernel]:
            raise AssertionError(f"--check {argv} launched {rose}")
    real = kr.single_pass_plain
    kr.single_pass_plain = lambda x2d, op: real(x2d, registry.get_op("MAX"))
    try:
        text = run_row(driver, CHECK_ROWS[0][0] + ["--check"], want_rc=1)
    finally:
        kr.single_pass_plain = real
    if "[MISMATCH]" not in text:
        raise AssertionError("the perturbed --check row did not MISMATCH")


def trace_path(driver, counted, kr, registry, config, staging) -> None:
    """A k6 row with --trace, and a chained one, whose trace holds its
    chain's graph: each trace must name k6's launches."""
    for extra, trace_dir in (([], TRACE_DIR),
                             (["--timing=chained", "--iterations=16"],
                              CHAIN_TRACE_DIR)):
        run_row(driver, ["--method=SUM", "--type=int", "--kernel=6",
                         f"--trace={trace_dir}", *extra])
        trace = trace_dir / "trace.json"
        events = json.loads(trace.read_text())["traceEvents"]
        k6 = [e for e in events if "fold_span" in str(e.get("name", ""))]
        print(f"  {trace}: {len(events)} events, {len(k6)} of k6's pass "
              "(fold_span)", flush=True)
        if len(k6) < 3:
            raise AssertionError(f"{trace} names {len(k6)} k6 launches")


@contextlib.contextmanager
def timed(module, name: str, calls: list, dev=None):
    """Replace module.name, for the block, by a wrapper that appends each
    call's host seconds to `calls` (to the card's end of its work when
    `dev` is given)."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        # redlint: disable=RED002 -- the phases' call counter: host seconds a CLI spends, to its card's end, printed beside the rows; no kernel time is read from it
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        if dev is not None:
            torch.cuda.synchronize(dev)
        # redlint: disable=RED002 -- closes the host-seconds window of the line above
        calls.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def staging_path(driver, counted, kr, registry, config, staging) -> None:
    """Each STAGING_ROWS row, under its environment, PASSED and staged in
    chunks (device_put_chunked called once), with the host time of its
    native fill, its staging (and rate) and its SUM oracle."""
    fills, puts, sums = [], [], []
    dev = torch.device("cuda", torch.cuda.current_device())
    with timed(driver.oracle, "native_fill", fills), \
            timed(staging, "device_put_chunked", puts, dev), \
            timed(driver, "host_reduce", sums):
        for argv, env in STAGING_ROWS:
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                bound = config.stage_chunk_bytes()
                for calls in (fills, puts, sums):
                    del calls[:]
                run_row(driver, argv)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k)
                    else:
                        os.environ[k] = v
            if len(puts) != 1:
                raise AssertionError(f"{argv} {env}: not staged in chunks")
            nbytes = STAGING_N * 4
            print(f"  native fill {sum(fills):.4f} s; staged {nbytes} B in "
                  f"{-(-nbytes // bound)} chunks of at most {bound} B: "
                  f"{puts[0]:.4f} s, {nbytes / puts[0] / 1e9:.4f} GB/s; "
                  f"SUM oracle {sum(sums):.4f} s", flush=True)


EXPERIMENT_DIR = Path("out") / "smoke_experiment"
EXPERIMENT_LINE = re.compile(r"^(sweep |shmoo |experiment|hazard cell|report:|"
                             r"writeup)")


def experiment_path(driver, counted, kr, registry, config, staging) -> None:
    """The flagship experiment into EXPERIMENT_DIR, afresh: exit 0, every
    grid and curve cell PASSED and cached, through k6; its artifacts; no
    HBM fraction above 1.05; the averages, each curve's peak, N_1/2 and
    cliff."""
    from tpu_reductions_torch.bench import experiment, findings, sweep
    from tpu_reductions_torch.bench.report import REFERENCE_SINGLE_GPU
    shutil.rmtree(EXPERIMENT_DIR, ignore_errors=True)
    rc, text, seconds = run_cli(experiment.main, [str(EXPERIMENT_DIR)])
    (EXPERIMENT_DIR / "experiment.log").write_text(text)
    print("".join(line for line in text.splitlines(keepends=True)
                  if EXPERIMENT_LINE.match(line)), end="", flush=True)
    grid = sweep.FLAGSHIP_GRID
    cells = [json.loads(f.read_text()) for f in sorted(
        (EXPERIMENT_DIR / "single_chip" / "raw_output").glob("run-*.json"))]
    want = len(grid["dtypes"]) * len(grid["methods"]) * grid["repeats"]
    if rc != 0 or len(cells) != want \
            or any(c["status"] != "PASSED" for c in cells):
        raise AssertionError(f"experiment: exit {rc}, {len(cells)} of "
                             f"{want} grid cells cached")
    if counted["k6"].launches == 0:
        raise AssertionError("the experiment never launched k6")
    avgs = json.loads((EXPERIMENT_DIR / "single_chip"
                       / "averages.json").read_text())
    if len(avgs) != 6:
        raise AssertionError(f"averages.json: {sorted(avgs)}")
    for key, gbps in avgs.items():
        ref = REFERENCE_SINGLE_GPU[tuple(key.split())]
        print(f"  {key:10s} {gbps:.4f} GB/s (reference GPU {ref}, "
              f"{gbps / ref:.2f}x)")
    rows = json.loads((EXPERIMENT_DIR / "shmoo.json").read_text())
    expected = {(dt, 1 << p) for dt, top in experiment.CURVES
                for p in range(experiment.CURVE_MIN_POW, top + 1)}
    expected.add(("int32", 1 << experiment.HAZARD_POW))
    got = {(r["dtype"], r["n"]) for r in rows if r["status"] == "PASSED"}
    if got != expected:
        raise AssertionError(f"curve cells missing: {expected - got}")
    ann = json.loads((EXPERIMENT_DIR / "roofline.json").read_text())
    over = [(r["dtype"], r["n"], r["hbm_fraction"]) for r in ann
            if r.get("hbm_fraction", 0.0) > 1.05]
    if over:
        raise AssertionError(f"HBM fractions above 1.05: {over}")
    for dtype, _ in experiment.CURVES:
        peak = max((r for r in ann if r["dtype"] == dtype),
                   key=lambda r: r["gbps"])
        print(f"  {dtype} SUM curve: peak {peak['gbps']:.4f} GB/s at "
              f"n=2^{peak['n'].bit_length() - 1} ({peak['regime']})")
    for line in findings.half_power_points(ann) + findings.l2_cliff(ann):
        print(f"  {line}")
    figures = [f.name for f in EXPERIMENT_DIR.glob("bandwidth_vs_n.*")]
    if not ((EXPERIMENT_DIR / "report.md").exists()
            and (EXPERIMENT_DIR / "report.tex").exists()
            and ({"bandwidth_vs_n.png", "bandwidth_vs_n.eps"} <= set(figures)
                 or "bandwidth_vs_n.dat" in figures)
            and ((EXPERIMENT_DIR / "writeup.pdf").exists()
                 or "writeup skipped (no matplotlib)" in text)):
        raise AssertionError(f"experiment artifacts missing: {figures}")
    print(f"  ({seconds:.1f} s) figures {sorted(figures)}", flush=True)


def _eager_chain(core, op, planes, k):
    """The chain's plain loop on the card: the bits its graph must give."""
    from tpu_reductions_torch.ops.chain import fold_into
    planes = tuple(p.clone() for p in planes)
    for _ in range(k):
        last = core(*planes)
        last = last[0] if isinstance(last, tuple) else last
        fold_into(planes[0], last, op)
    return last


def chain_path(driver, counted, kr, registry, config, staging) -> None:
    """The chain as one CUDA graph: k6, k8 and the pair route give the
    plain loop's bits at every CHAIN_KS, each replay counted; then the
    chained CHAIN_ROW, whose slope must stay within CHAIN_RATIO of k6's
    reduce plus the fold."""
    from tpu_reductions_torch.ops import dd_reduce as dd
    from tpu_reductions_torch.ops.chain import fold_into, make_chained_reduce
    from tpu_reductions_torch.utils.rng import host_data
    dev = torch.device("cuda", torch.cuda.current_device())
    op = registry.get_op("SUM")
    stage, dd_core, _ = dd.make_dd_device_reduce("SUM", N, device=dev)
    hi2d, lo2d, _ = stage(host_data(N, "float64").numpy())
    cases = {"dd": (dd_core, (hi2d, lo2d))}
    for name, kernel in (("k6", 6), ("k8", 8)):
        _, stage_fn, core = kr.make_staged_core("SUM", N, "int32",
                                                kernel=kernel, device=dev)
        cases[name] = (core, (stage_fn(host_data(N, "int32")),))
    for name, (core, planes) in cases.items():
        for k in CHAIN_KS:
            want = _eager_chain(core, op, planes, k)
            chained = make_chained_reduce(core, op)
            before = counted[name].launches
            got = chained(planes if len(planes) > 1 else planes[0], k)
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"[chain] {name} k={k}: the graph's "
                                     f"bits differ from the plain loop's")
            if counted[name].launches - before != 1 + k:
                raise AssertionError(f"[chain] {name} k={k}: counted "
                                     f"{counted[name].launches - before} "
                                     f"launches, not 1 + {k}")
            chained.close()
        print(f"  {name}: the graph gives the plain loop's bits at k = "
              f"{CHAIN_KS}", flush=True)
    x2d = cases["k6"][1][0]
    reduce_ms = device_ms(lambda: kr.finish(kr.single_pass_call(x2d, op), op))
    head = x2d[:8].clone()
    last = torch.ones((), dtype=torch.int32, device=dev)
    fold_ms = device_ms(lambda: fold_into(head, last, op))
    res = driver.run_benchmark(config.ReduceConfig(**CHAIN_ROW))
    slope_ms = res.avg_s * 1e3
    bound_ms = CHAIN_RATIO * (reduce_ms + fold_ms)
    print(f"  chained int32 SUM n={N} through k6: {slope_ms:.5f} ms an "
          f"iteration ({res.gbps:.4f} GB/s) against reduce_ms "
          f"{reduce_ms:.5f} + fold_ms {fold_ms:.5f} "
          f"(ratio {slope_ms / (reduce_ms + fold_ms):.3f}, limit "
          f"{CHAIN_RATIO}) [{res.status.name}]", flush=True)
    if not res.passed or slope_ms > bound_ms:
        raise AssertionError(f"[chain] slope {slope_ms:.5f} ms over "
                             f"{bound_ms:.5f}, or the row did not PASS")


def spot_path(driver, counted, kr, registry, config, staging) -> None:
    """The spot CLI on SPOT_ROWS at n = 2^24: every row PASSED, each
    through its kernel."""
    from tpu_reductions_torch.bench import spot
    shutil.rmtree(OUT / "smoke_spot", ignore_errors=True)
    (OUT / "smoke_spot").mkdir(parents=True)
    for argv, kernel in SPOT_ROWS:
        out = OUT / "smoke_spot" / f"{argv[0][7:]}.json"
        before = counted[kernel].launches
        rc, text, seconds = run_cli(spot.main, argv + [f"--n={N}",
                                                       f"--out={out}"])
        print(text, end="")
        rows = json.loads(out.read_text())["rows"]
        print(f"  ({seconds:.1f} s)", flush=True)
        if rc != 0 or [r["status"] for r in rows] != ["PASSED"] * 3:
            raise AssertionError(f"spot {argv}: exit {rc}")
        if counted[kernel].launches == before:
            raise AssertionError(f"spot {argv} never launched {kernel}")


def smoke_path(driver, counted, kr, registry, config, staging) -> None:
    """The smoke CLI: every case PASSED or WAIVED; its dd cases launch
    the pair kernel, its k8, k9 and k10 cases theirs."""
    from tpu_reductions_torch.bench import smoke
    out = OUT / "smoke_smoke" / "smoke.json"
    shutil.rmtree(out.parent, ignore_errors=True)
    out.parent.mkdir(parents=True)
    rc, text, seconds = run_cli(smoke.main, [f"--out={out}"])
    print(text, end="")
    print(f"  ({seconds:.1f} s)", flush=True)
    cases = json.loads(out.read_text())["cases"]
    bad = [c["name"] for c in cases
           if c["status"] not in ("PASSED", "WAIVED")]
    if rc != 0 or bad or len(cases) != len(smoke.CASES) + len(
            smoke.FAMILY_CASES):
        raise AssertionError(f"smoke: exit {rc}, not verified: {bad}")
    missing = [k for k in ("k8", "k9", "k10", "dd")
               if counted[k].launches == 0]
    if missing:
        raise AssertionError(f"smoke never launched {missing}")


def family_path(driver, counted, kr, registry, config, staging) -> None:
    """The family-spot CLI at n = 2^24 with 64 segments: every cell
    verified and PASSED."""
    from tpu_reductions_torch.bench import family_spot
    out = OUT / "smoke_family" / "family_spot.json"
    shutil.rmtree(out.parent, ignore_errors=True)
    out.parent.mkdir(parents=True)
    rc, text, seconds = run_cli(family_spot.main, [
        f"--n={FAMILY_N}", "--segments=64", f"--out={out}"])
    print(text, end="")
    print(f"  ({seconds:.1f} s)", flush=True)
    rows = json.loads(out.read_text())["rows"]
    if rc != 0 or len(rows) != len(family_spot.family_cells()) \
            or any(r["status"] != "PASSED" for r in rows):
        raise AssertionError(f"family_spot: exit {rc}")
    keep_evidence(out, "family")


def firstrow_path(driver, counted, kr, registry, config, staging) -> None:
    """The firstrow CLI into out/: the headline row PASSED, its snapshot
    beside it, the three doubles PASSED through the pair kernel."""
    from tpu_reductions_torch.bench import firstrow, headline
    out = OUT / "smoke_firstrow" / "FIRSTROW.json"
    shutil.rmtree(out.parent, ignore_errors=True)
    out.parent.mkdir(parents=True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, text, seconds = run_cli(firstrow.main, [f"--out={out}"])
    print(text + "".join(line for line in err.getvalue().splitlines(True)
                         if line.startswith(("firstrow:", "# doubles:"))),
          end="")
    print(f"  ({seconds:.1f} s) candidate {headline.CANDIDATES[0]}",
          flush=True)
    data = json.loads(out.read_text())
    doubles = json.loads(Path(f"{out}.doubles.json").read_text())["rows"]
    if rc != 0 or not data["complete"] or data["row"]["status"] != "PASSED" \
            or not Path(f"{out}.snapshot.json").exists() \
            or [r["status"] for r in doubles] != ["PASSED"] * 3:
        raise AssertionError(f"firstrow: exit {rc}")
    if counted["dd"].launches == 0:
        raise AssertionError("firstrow's doubles never launched dd")


def warm_path(driver, counted, kr, registry, config, staging) -> None:
    """The warm CLI: the build cold and warm, every surface's first call
    against a warm one, none failed."""
    from tpu_reductions_torch.bench import warm
    out = OUT / "smoke_warm" / "compile_ledger.json"
    shutil.rmtree(out.parent, ignore_errors=True)
    out.parent.mkdir(parents=True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, text, seconds = run_cli(warm.main, [f"--out={out}"])
    print(err.getvalue() + text, end="")
    print(f"  ({seconds:.1f} s)", flush=True)
    rows = json.loads(out.read_text())["surfaces"]
    want = {(s, v) for s in [warm.BUILD_SURFACE]
            + [s for s, _ in warm.surfaces()] for v in ("cold", "warm")}
    if rc != 0 or {(r["surface"], r["verdict"]) for r in rows} != want:
        raise AssertionError(f"warm: exit {rc}")
    keep_evidence(out, "compile")


# [collective]: the reduce.c grid (int32 and float64 x MAX/MIN/SUM) at
# k = 8 over n = 2^27 (512 MiB of int32, 1 GiB of float64; constants.h's
# 2 GiB cut to keep the phase near two minutes), periter and chained;
# rooted rows; the pair route at 2^26; the rank ladder at 2^26
COLL_N = 1 << 27
COLL_K = 8
COLL_RETRIES = 5
COLL_SPAN = 16
# MIN scatter at k = 6: n a multiple of 36, so that the slice fallback's
# k * (L // k) elements are the whole reduced row the check compares with
COLL_K6_N = COLL_N - COLL_N % 36
ROOTED_ROWS = (
    [(dict(method=m, rooted=r, num_devices=COLL_K, n=COLL_N), label)
     for m, r, label in (("SUM", "scatter", "reduce_scatter"),
                         ("MIN", "scatter", "reduce_scatter"),
                         ("SUM", "root", "reduce_to_root_rs_ag"),
                         ("MIN", "root", "reduce_to_root_rs_ag"))]
    + [(dict(method="MIN", rooted="scatter", num_devices=6, n=COLL_K6_N),
        "all_reduce_slice")])
PAIR_N = 1 << 26
PAIR_ROWS = (   # per-rank 2^26 // 3 = 22369621 is no multiple of 3
    (dict(method="SUM", num_devices=8), "dd_ring_rs_ag"),
    (dict(method="SUM", num_devices=3), "dd_ring_naive"),
    (dict(method="MIN", num_devices=8), "key_two_phase_all_reduce"),
    (dict(method="MAX", num_devices=8), "key_two_phase_all_reduce"))
LADDER_N = 1 << 26
LADDER_KS = (2, 8, 64, 256, 1024)   # 64/256/1024: the reference's ranks


def collective_bound_ms(row) -> float:
    """The least time the card could take for a row's collective: its
    payload read once and its per-rank result written once (k rows of L,
    or of L/k under a reduce-scatter), over the memory rate. The f64 pair
    planes move the 8 bytes an element that native f64 does."""
    itemsize = {"int32": 4, "float32": 4, "float64": 8, "bfloat16": 2}[
        row.dtype]
    per_rank = row.n // row.ranks
    out = (per_rank // row.ranks * row.ranks
           if row.algorithm in ("reduce_scatter", "all_reduce_slice")
           else per_rank * row.ranks)
    return 1e3 * itemsize * (per_rank * row.ranks + out) / HBM_BYTES_PER_S


def run_collective(collective_driver, config, want_label, suite=False,
                   **fields) -> list:
    """One collective config (or, with suite, its reduce.c grid) on the
    card: every row PASSED with `want_label` (a dict by method for the
    grid); each row printed with its algorithm, seconds, reference GB/s,
    busbw, status and bound."""
    log = io.StringIO()
    cfg = config.CollectiveConfig(**fields)
    logger = collective_driver.BenchLogger(None, None, console=log)
    t0 = time.perf_counter()
    rows = (collective_driver.run_collective_suite(cfg, logger=logger)
            if suite else
            collective_driver.run_collective_benchmark(cfg, logger=logger))
    seconds = time.perf_counter() - t0
    for r in rows:
        bound_ms = collective_bound_ms(r)
        print(f"  {r.dtype} {r.method} k={r.ranks} n={r.n} "
              f"rooted={r.rooted} {cfg.timing} rep {r.repeat}: "
              f"{r.algorithm} {r.time_s:.6f} s, {r.reference_gbps:.4f} "
              f"GB/s, busbw {r.busbw_gbps:.4f}, bound {bound_ms:.5f} ms "
              f"({1e3 * r.time_s / bound_ms:.2f}x) [{r.status.name}]")
        label = want_label[r.method] if isinstance(want_label, dict) \
            else want_label
        if r.status.name != "PASSED" or r.algorithm != label:
            raise AssertionError(f"[collective] {fields}: {r.algorithm} "
                                 f"[{r.status.name}], expected {label}")
    print(f"  ({seconds:.1f} s)", flush=True)
    return rows


def collective_path(driver, counted, kr, registry, config, staging) -> None:
    """The collective driver on the card: the reduce.c grid periter and
    chained, the rooted rows, the pair route, the rank ladder, every row
    PASSED with its label and bound; the chained slope of int32 SUM at
    k = 8 against one collective call plus the fold, both timed with CUDA
    events here. The collectives launch no kernel of the repository (the
    JAX package's are XLA collectives and jnp)."""
    from tpu_reductions_torch.bench import collective_driver as cd
    from tpu_reductions_torch.collectives import (make_collective_reduce,
                                                  shard_payload)
    from tpu_reductions_torch.ops.chain import fold_into
    from tpu_reductions_torch.parallel.mesh import build_mesh
    all_reduce = dict.fromkeys(METHODS, "all_reduce")
    # the driver's own note and header, once, through its CLI
    rc, text, seconds = run_cli(cd.main, [
        "--method=SUM", "--type=int", f"--n={COLL_N}",
        f"--devices={COLL_K}", "--retries=2"])
    print(text, end="")
    if rc != 0 or "note: the 8 ranks are rows of one tensor" not in text:
        raise AssertionError(f"collective CLI: exit {rc}")
    grid = {}
    for timing in ("periter", "chained"):
        grid[timing] = run_collective(
            cd, config, all_reduce, suite=True, n=COLL_N,
            num_devices=COLL_K, retries=COLL_RETRIES, timing=timing,
            chain_span=COLL_SPAN)
    for fields, label in ROOTED_ROWS:
        run_collective(cd, config, label, retries=3, **fields)
    for fields, label in PAIR_ROWS:
        for timing in ("periter", "chained"):
            run_collective(cd, config, label, retries=3,
                           dtype="float64", f64="dd", n=PAIR_N,
                           timing=timing, chain_span=COLL_SPAN, **fields)
    for dtype in ("int32", "float64"):
        for k in LADDER_KS:
            run_collective(cd, config, "all_reduce", dtype=dtype,
                           n=LADDER_N, num_devices=k, retries=3,
                           timing="chained", chain_span=COLL_SPAN)
    # the slope check: the chained int32 SUM rows of the grid against one
    # call of the same collective on the same payload, plus the fold
    slope_ms = 1e3 * statistics.median(
        r.time_s for r in grid["chained"]
        if r.dtype == "int32" and r.method == "SUM")
    mesh = build_mesh(num_devices=COLL_K, platform="gpu",
                      local_ranks=COLL_K)
    cfg = config.CollectiveConfig(method="SUM", n=COLL_N,
                                  num_devices=COLL_K)
    x = shard_payload(cd._build_payload(cfg, COLL_K), mesh)
    coll = make_collective_reduce("SUM", mesh)
    call_ms = device_ms(lambda: coll(x))
    op = registry.get_op("SUM")
    head = x[:, :8].clone()
    last = torch.ones((), dtype=torch.int32, device=mesh.device)
    fold_ms = device_ms(lambda: fold_into(head, last, op))
    ratio = slope_ms / (call_ms + fold_ms)
    print(f"  chained int32 SUM k={COLL_K} n={COLL_N}: {slope_ms:.5f} ms "
          f"an iteration against call_ms {call_ms:.5f} + fold_ms "
          f"{fold_ms:.5f} (ratio {ratio:.3f}, limit {CHAIN_RATIO})",
          flush=True)
    if ratio > CHAIN_RATIO:
        raise AssertionError(f"[collective] chained slope ratio {ratio:.3f}"
                             f" over {CHAIN_RATIO}")
    del x, head


ROUND_OUT = OUT / "smoke_round"
ROUND_KEYS = {"metric", "value", "unit", "vs_baseline"}


def round_path(driver, counted, kr, registry, config, staging) -> None:
    """bench.round at its defaults on the card: exit 0, exactly one JSON
    line with bench.py's four keys, value > 0, vs_baseline =
    round(value / 90.8413, 4); the candidates' rows; k6, k7 and k8
    launched by the candidates, dd by the doubles."""
    from tpu_reductions_torch.bench import headline
    from tpu_reductions_torch.bench import round as round_cli
    shutil.rmtree(ROUND_OUT, ignore_errors=True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, text, seconds = run_cli(round_cli.main, [f"--out={ROUND_OUT}"])
    lines = [ln for ln in text.splitlines() if ln.strip()]
    print("".join(ln for ln in err.getvalue().splitlines(True)
                  if ln.startswith("#")), end="")
    print("\n".join(lines))
    print(f"  ({seconds:.1f} s)", flush=True)
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"round: exit {rc}, {len(lines)} stdout lines")
    line = json.loads(lines[0])
    if set(line) != ROUND_KEYS or not line["value"] > 0 \
            or line["vs_baseline"] != round(
                line["value"] / headline.BASELINE_GBPS, 4):
        raise AssertionError(f"round: {line}")
    missing = [k for k in ("k6", "k7", "k8", "dd")
               if counted[k].launches == 0]
    if missing or not (ROUND_OUT / "snapshot.json").exists():
        raise AssertionError(f"round never launched {missing}, or wrote "
                             "no snapshot")


# [quant]: the collective CLI under --quantized at the [collective] width
# (k = 8, n = 2^27; the f64 dd planes at 2^26): (method, dtype, bits, the
# label the row must carry), every row chained; float SUM 8 periter too;
# and one geometry whose per-rank length is no multiple of k * 256, which
# falls back to the exact psum
QUANT_LABELS = {"float32": "q{b}_ring_rs_ag",
                "bfloat16": "q{b}_bf16_ring_rs_ag",
                "float64": "q{b}_dd_ring_rs_ag"}
KEY_LABELS = {"float32": "q{b}_key_minmax_all_reduce",
              "float64": "q{b}_key_two_phase_all_reduce"}
QUANT_ROWS = (
    [("SUM", t, b, QUANT_LABELS[t].format(b=b))
     for t in ("float32", "bfloat16", "float64") for b in (4, 8, 16)]
    + [(m, t, b, KEY_LABELS[t].format(b=b))
       for m in ("MIN", "MAX") for t in ("float32", "float64")
       for b in (8, 16)])
QUANT_FALLBACK_N = COLL_N - 8
# a quantized ring call takes milliseconds: a span of 4 holds tens of ms
QUANT_SPAN = 4
FALLBACK_NOTE = "quantized ring fell back to the exact f32 psum"


def quant_path(driver, counted, kr, registry, config, staging) -> None:
    """The quantized collectives on the card through the collective
    driver, k = 8: SUM over float32/bfloat16/float64 at 4/8/16 bits, MIN
    and MAX over float32/float64 at 8/16, chained (float SUM 8 periter
    too), and the exact-psum fallback geometry; every row PASSED within
    its declared bound (MIN/MAX exact) with its label, each config's
    median ms beside its bound. No kernel of the repository: the JAX
    package's quantized rings are jnp and XLA collectives."""
    from tpu_reductions_torch.bench import collective_driver as cd

    def median_row(rows, what):
        ms = 1e3 * statistics.median(r.time_s for r in rows)
        bound_ms = collective_bound_ms(rows[0])
        print(f"  -> {what}: {rows[0].algorithm} median {ms:.5f} ms, "
              f"bound {bound_ms:.5f} ms ({ms / bound_ms:.2f}x)",
              flush=True)

    for method, dtype, bits, label in QUANT_ROWS:
        n = PAIR_N if dtype == "float64" else COLL_N
        rows = run_collective(cd, config, label, method=method,
                              dtype=dtype, n=n, num_devices=COLL_K,
                              retries=3, quantized=True, quant_bits=bits,
                              timing="chained", chain_span=QUANT_SPAN)
        median_row(rows, f"{dtype} {method} q{bits} chained")
    rows = run_collective(cd, config, QUANT_LABELS["float32"].format(b=8),
                          method="SUM", dtype="float32", n=COLL_N,
                          num_devices=COLL_K, retries=3, quantized=True,
                          quant_bits=8)
    median_row(rows, "float32 SUM q8 periter")
    # the fallback, through the CLI, whose row must say so
    rc, text, seconds = run_cli(cd.main, [
        "--method=SUM", "--type=float", f"--n={QUANT_FALLBACK_N}",
        f"--devices={COLL_K}", "--quantized", "--quant-bits=8",
        "--retries=2"])
    print(text, end="")
    print(f"  ({seconds:.1f} s)", flush=True)
    if rc != 0 or FALLBACK_NOTE not in text:
        raise AssertionError(f"[quant] fallback row: exit {rc}")


RANK_SCALING_OUT = OUT / "smoke_rank_scaling"
RANK_SCALING_ARGV = [f"--ranks={','.join(map(str, LADDER_KS))}",
                     f"--n={LADDER_N}", "--retries=1",
                     f"--curve-n={1 << 24}", "--rows=4096"]
QUANT_CURVE_CELLS = 102
RESHARD_CURVE_CELLS = 42
PERMUTE_PAIRS = ("row_to_col", "col_to_row")


def rank_scaling_path(driver, counted, kr, registry, config,
                      staging) -> None:
    """bench.rank_scaling on the card: the rank sweep (int32 and float64
    x MAX/MIN/SUM at 2^26, ranks 2/8/64/256/1024, one retry), its
    averages and figures, the amortisation probe at 1024 ranks, the
    quantized curve (102 cells) and the reshard curve (42 cells) at 2^24
    over ranks 2..64. Every row PASSED; each sweep row printed with its
    ms and bound; each reshard row's accounted memory factor (the JAX
    package's, from shapes) within its declared one and printed beside
    the card allocator's peak factor (not gated: it counts the ops'
    temporaries), its ms the median of warm calls, and the permute
    pairs' planned wire under the naive program's. The full log goes to
    OUT/rank_scaling.log."""
    import types
    from tpu_reductions_torch.bench import rank_scaling
    shutil.rmtree(RANK_SCALING_OUT, ignore_errors=True)
    rc, text, seconds = run_cli(rank_scaling.main,
                                [str(RANK_SCALING_OUT),
                                 *RANK_SCALING_ARGV])
    (RANK_SCALING_OUT / "rank_scaling.log").write_text(text)
    print(f"  rank_scaling exit {rc} ({seconds:.1f} s)", flush=True)
    print("".join(f"  {ln}\n" for ln in text.splitlines()
                  if ln.startswith("stage ")), end="")
    sweep = json.loads((RANK_SCALING_OUT
                        / "collective_sweep.json").read_text())["rows"]
    for r in sweep:
        row = types.SimpleNamespace(**r)
        bound_ms = collective_bound_ms(row)
        print(f"  {r['dtype']} {r['method']} k={r['ranks']} n={r['n']}: "
              f"{r['algorithm']} {1e3 * r['time_s']:.5f} ms, "
              f"{r['reference_gbps']:.4f} GB/s, bound {bound_ms:.5f} ms "
              f"({1e3 * r['time_s'] / bound_ms:.2f}x) [{r['status']}]")
    shape = json.loads((RANK_SCALING_OUT
                        / "scaling_shape.json").read_text())
    print(f"  amortisation probe at k={shape['amortization_probe_ranks']}:"
          f" {shape['amortization_probe']}")
    quant = json.loads((RANK_SCALING_OUT
                        / "quant_curve.json").read_text())["rows"]
    worst = {}
    for r in quant:
        key = (r["method"], r["dtype"], r["bits"])
        if key not in worst or r["max_err"] / max(r["bound"], 1e-300) > \
                worst[key]["max_err"] / max(worst[key]["bound"], 1e-300):
            worst[key] = r
    for (method, dtype, bits), r in sorted(worst.items()):
        print(f"  quant_curve {method} {dtype} q{bits}: worst k="
              f"{r['ranks']} err {r['max_err']:.3e} bound {r['bound']:.3e}"
              f" wire x{r['wire_reduction']:.3f} [{r['status']}]")
    reshard = json.loads((RANK_SCALING_OUT
                          / "reshard_curve.json").read_text())["rows"]
    for r in reshard:
        print(f"  reshard {r['pair']} {r['wire']} k={r['ranks']} "
              f"[{'+'.join(r['program'])}] {r['gbps']:.3f} GB/s, "
              f"{1e3 * r['wall_s']:.5f} ms, mem accounted/declared "
              f"{r['measured_mem_factor']}/{r['mem_factor']}, card peak "
              f"{r['device_mem_factor']} (steps "
              f"{[s['device_mem_factor'] for s in r['steps']]}), err "
              f"{r['max_err']:.2e} [{r['status']}]")
    bad = ([r for r in sweep if r["status"] != "PASSED"]
           + [r for r in quant + reshard if r["status"] != "PASSED"]
           + [r for r in reshard
              if r["measured_mem_factor"] > r["mem_factor"]
              or r["device_mem_factor"] is None
              or (r["pair"] in PERMUTE_PAIRS
                  and not r["plan_wire_bytes"] < r["naive_wire_bytes"])])
    if rc != 0 or bad or len(quant) != QUANT_CURVE_CELLS \
            or len(reshard) != RESHARD_CURVE_CELLS \
            or len(shape["amortization_probe"]) != 3:
        raise AssertionError(f"[rank_scaling] exit {rc}, {len(bad)} rows "
                             f"not as required, {len(quant)} quant and "
                             f"{len(reshard)} reshard cells")
    keep_evidence(RANK_SCALING_OUT / "scaling_shape.json", "scaling")
    keep_evidence(RANK_SCALING_OUT / "quant_curve.json", "quant")


def exec_path(driver, counted, kr, registry, config, staging) -> None:
    """`python -m tpu_reductions_torch.exec --explain` over this run's own
    evidence (EVIDENCE_ROOT): every decision printed, the kernel axis
    priced from the race and the stream probe, the scan axis's float
    cells from the family grid, and no axis on its static fallback."""
    from tpu_reductions_torch.exec import __main__ as explain
    out = OUT / "smoke_exec" / "exec_decisions.json"
    shutil.rmtree(out.parent, ignore_errors=True)
    out.parent.mkdir(parents=True)
    os.environ["TPU_REDUCTIONS_EVIDENCE_ROOT"] = str(EVIDENCE_ROOT)
    try:
        rc, text, seconds = run_cli(explain.main, ["--explain",
                                                   f"--out={out}"])
    finally:
        del os.environ["TPU_REDUCTIONS_EVIDENCE_ROOT"]
    print(text, end="")
    print(f"  ({seconds:.1f} s)", flush=True)
    rows = json.loads(out.read_text())["rows"]
    kernel = [r for r in rows if r["axis"] == "kernel"]
    scan = [r for r in rows if r["axis"] == "scan"
            and r["geometry"]["dtype"] != "int32"]
    unpriced = [r for r in kernel if "out/tune.json" not in r["evidence"]]
    unpriced += [r for r in scan
                 if "out/family_spot.json" not in r["evidence"]]
    unpriced += [r for r in rows if r["axis"] == "topology"
                 and not r["evidence"]]
    if rc != 0 or len(rows) != 19 or unpriced:
        raise AssertionError(f"[exec] exit {rc}: {len(unpriced)} decisions "
                             "fell back to the static pick")


# [serve]: the closed loop at JAX's default size and at 2^22 (16 MiB a
# request, up to 128 MiB a batch), 8 clients x 32 requests of
# SUM/MIN/MAX, coalesced and sequential; then through one engine a
# float64 request, the family's serving cells at 2^22 and one oversized
# 2^28 int32 request (1 GiB, streamed); and a --connect row against the
# TCP front end
SERVE_LOADS = ((1 << 16, "int"), (1 << 22, "int"), (1 << 22, "float"))
SERVE_LOOP = ["--clients=8", "--requests=32", "--methods=SUM,MIN,MAX"]
SERVE_N = 1 << 22
OVERSIZED_N = 1 << 28


def serve_row(label, row) -> str:
    """One load generator row: its rates, and the executor's seconds of
    each step over the row's batches, in all and a batch."""
    s = row.get("seconds") or {}
    per = max(row.get("batches") or 0, 1)
    return (f"  serve {label} {row['mode']}: {row['rps']} req/s, p50 "
            f"{row.get('p50_ms')} ms, p99 {row.get('p99_ms')} ms, "
            f"mean_batch {row['mean_batch']}, ok {row['ok']}/"
            f"{row['requests']}, batches {row.get('batches')}, launches "
            f"{row.get('launches')}, copy {row.get('copy_route')}, "
            "executor s " + " ".join(f"{k} {v:.4f}" for k, v in s.items())
            + " | ms a batch " + " ".join(f"{k} {1e3 * v / per:.3f}"
                                          for k, v in s.items()))


def serve_path(driver, counted, kr, registry, config, staging) -> None:
    """The serving path on the card (serve/): the load generator's rows
    (SERVE_LOADS), every response ok and verified, `coalesced` batching
    above 1 at 8 clients, and the engine's batches equal to its executor's
    serve-bucket launches; then one engine serving a float64 request, the
    family's SERVE_CELLS and an oversized request through the stream
    route; then the TCP front end in its own process, driven by the load
    generator's --connect."""
    from tpu_reductions_torch.bench import family_spot
    from tpu_reductions_torch.serve import loadgen
    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.executor import BatchExecutor
    from tpu_reductions_torch.serve.request import ReduceRequest
    out_dir = OUT / "smoke_serve"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    bad = []
    for n, dtype in SERVE_LOADS:
        label = f"{dtype} n={n}"
        out = out_dir / f"curve_{dtype}_{n}.json"
        rc, text, seconds = run_cli(loadgen.main, SERVE_LOOP + [
            f"--n={n}", f"--type={dtype}", f"--out={out}"])
        rows = json.loads(out.read_text())["rows"]
        print(f"  serve {label}: exit {rc} ({seconds:.1f} s)", flush=True)
        for r in rows:
            print(serve_row(label, r), flush=True)
            if r["ok"] != r["requests"] or r["requests"] != 256 \
                    or r["batches"] != r["launches"] \
                    or (r["mode"] == "coalesced"
                        and not r["mean_batch"] > 1):
                bad.append((label, r["mode"]))
        if rc != 0 or len(rows) != 2:
            bad.append((label, rc))
    # one engine: float64, the family's cells, the oversized stream
    executor = BatchExecutor()
    engine = ServeEngine(executor=executor, coalesce_window_s=0.0).start()
    t0 = time.perf_counter()
    try:
        reqs = [ReduceRequest(method="SUM", dtype="double", n=SERVE_N,
                              seed=1)]
        reqs += [ReduceRequest(method=m, dtype=d, n=SERVE_N, seed=s)
                 for m, d in family_spot.SERVE_CELLS for s in range(3)]
        reqs += [ReduceRequest(method="SUM", dtype="int", n=OVERSIZED_N,
                               seed=2)]
        pending = [engine.submit(r) for r in reqs]
        resps = [p.result(timeout=300) for p in pending]
    finally:
        engine.stop()
    print(f"  serve engine ({time.perf_counter() - t0:.1f} s): "
          f"stats {engine.stats}, launches {dict(executor.launches)}",
          flush=True)
    for q, r in zip(reqs, resps):
        print(f"  serve {q.method} {q.dtype} n={q.n}: {r.status} result "
              f"{r.result} batch {r.batch_size} latency {r.latency_s} s"
              + (f" error {r.error}" if r.error else ""), flush=True)
    if any(r.status != "ok" for r in resps) \
            or executor.launches["serve-stream/sum"] != 1 \
            or engine.stats["batches"] != sum(executor.launches.values()):
        bad.append(("engine", engine.stats))
    # the TCP front end, in a process of its own
    port_file = out_dir / "port"
    server = subprocess.Popen(
        [sys.executable, "-m", "tpu_reductions_torch.serve", "--port=0",
         f"--port-file={port_file}", "--max-seconds=300"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while not (port_file.exists() and port_file.read_text().strip()):
            if server.poll() is not None or time.perf_counter() - t0 > 120:
                raise AssertionError(f"[serve] the front end did not "
                                     f"start: {server.stderr.read()}")
            time.sleep(0.1)
        port = int(port_file.read_text())
        out = out_dir / "curve_connect.json"
        rc, text, seconds = run_cli(loadgen.main, SERVE_LOOP + [
            f"--connect=127.0.0.1:{port}", f"--out={out}"])
    finally:
        server.terminate()
        server.wait(60)
    rows = json.loads(out.read_text())["rows"]
    for r in rows:
        print(serve_row(f"int n={1 << 16} (TCP)", r), flush=True)
    if rc != 0 or [(r["mode"], r["ok"]) for r in rows] != [("remote",
                                                             256)]:
        bad.append(("connect", rc))
    if bad:
        raise AssertionError(f"[serve] not as required: {bad}")


# [fleet]: the replica fleet on the card (serve/router.py, journal.py,
# autoscale.py, the executor's shard route): the load generator's --scale,
# --elastic and --recovery as the JAX package's scripts/run_serving_*.sh
# run them, the router in a process of its own driven by --connect, and
# then no process of the phase may be left alive
FLEET_CLIENTS = "64,256,1024"
FLEET_RANKS = 8


def fleet_rows(label, rows) -> None:
    """Each row of a fleet artifact on a line of its own."""
    for r in rows:
        fields = {k: v for k, v in r.items()
                  if k not in ("trajectory", "epochs", "by_status",
                               "drains", "ledger")}
        print(f"  fleet {label}: {json.dumps(fields)}", flush=True)


def fleet_pids(out_dir) -> set:
    """Every process that wrote a line to a ledger of the phase: the
    routers and their replica children (each arms the ledger it inherits)
    and this process."""
    pids = set()
    for path in out_dir.glob("*.jsonl*"):
        for line in path.read_text(errors="replace").splitlines():
            try:
                pids.add(int(json.loads(line)["pid"]))
            except (ValueError, KeyError, TypeError):
                continue
    return pids - {os.getpid()}


def fleet_path(driver, counted, kr, registry, config, staging) -> None:
    """The fleet on the card: `--scale` (every series' rows resolved and
    ok; the sharded row ok over FLEET_RANKS ranks on every card of the
    host with its algorithm and its fill, fold, gather and combine
    seconds), `--elastic` (the replica count
    rises and falls; the drain sheds nothing where the kill sheds; the
    drain's reshard verified within its memory bound), `--recovery`
    (every idempotency key settles once, ok; no duplicate device execution
    across the controller's death or the drain; the restarted router
    adopts both live children), the router in its own process serving
    256 --connect requests, all ok; then no pid of the phase alive, nor
    among the card's compute processes."""
    from tpu_reductions_torch.obs import ledger
    from tpu_reductions_torch.serve import loadgen
    out_dir = (OUT / "smoke_fleet").resolve()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    bad = []

    def mode(name, argv):
        out = out_dir / f"serving_{name}.json"
        rc, text, seconds = run_cli(loadgen.main, argv + [f"--out={out}"])
        ledger.disarm()              # the next mode runs unrecorded
        rows = json.loads(out.read_text())["rows"]
        print(f"  fleet {name}: exit {rc}, {len(rows)} rows "
              f"({seconds:.1f} s)", flush=True)
        fleet_rows(name, rows)
        if rc != 0:
            bad.append((name, rc))
        return rows

    rows = mode("scale", ["--scale", f"--devices={FLEET_RANKS}",
                          "--replicas=4", "--seed=0",
                          f"--scale-clients={FLEET_CLIENTS}"])
    grid = [r for r in rows if r.get("series") != "sharded"]
    sharded = [r for r in rows if r.get("series") == "sharded"]
    if len(grid) != 11 or any(r["requests"] != r["clients"]
                              or r["ok"] != r["requests"] for r in grid):
        bad.append(("scale", "grid"))
    # the shard route spans every card of the host: one here
    cards = min(torch.cuda.device_count(), FLEET_RANKS)
    if len(sharded) != 1 or sharded[0]["status"] != "ok" \
            or sharded[0].get("devices") != FLEET_RANKS \
            or sharded[0].get("cards") != cards \
            or not sharded[0].get("algorithm"):
        bad.append(("scale", "sharded"))
    else:
        s = sharded[0]["seconds"]
        print(f"  fleet sharded n={sharded[0]['n']}: latency "
              f"{sharded[0]['latency_s']} s on {sharded[0]['cards']} "
              f"card(s), fill {s['fill']:.4f} s, fold {s['fold']:.4f} s, "
              f"gather {s['gather']:.6f} s, combine {s['combine']:.4f} s, "
              f"verify {s['verify']:.4f} s", flush=True)

    rows = mode("elastic", ["--elastic", "--plan=diurnal",
                            f"--devices={FLEET_RANKS}", "--seed=0",
                            f"--scale-clients={FLEET_CLIENTS}"])
    cells = [r for r in rows if r["key"].startswith("elastic@")]
    by_key = {r["key"]: r for r in rows}
    for r in cells:
        print(f"  fleet elastic {r['key']} trajectory "
              f"{json.dumps(r['trajectory'])}", flush=True)
    drain, kill = by_key.get("drain", {}), by_key.get("kill", {})
    reshard = drain.get("reshard") or {}
    if any(r["ok"] != r["requests"] for r in rows) \
            or not any(r["scale_ups"] and r["scale_downs"] for r in cells) \
            or drain.get("victim_shed") != 0 \
            or not kill.get("victim_shed") \
            or reshard.get("ok") is not True \
            or reshard.get("ranks") != FLEET_RANKS \
            or not reshard["measured_mem_factor"] <= reshard["mem_factor"]:
        bad.append(("elastic", [(r["key"], r.get("scale_ups"),
                                 r.get("scale_downs"),
                                 r.get("victim_shed")) for r in rows]))

    rows = mode("recovery", ["--recovery", "--recovery-requests=48",
                             "--crash-after=16", "--seed=0"])
    by_key = {r["key"]: r for r in rows}
    kr_row = by_key.get("kill_router", {})
    if sorted(by_key) != ["drain", "kill_replica", "kill_router"] \
            or any(r["requests"] != 48 or r["ok"] != 48 for r in rows) \
            or kr_row.get("executed_keys") != 48 \
            or kr_row.get("duplicates") != 0 \
            or by_key["drain"].get("duplicates") != 0 \
            or kr_row.get("adopted") != 2 or kr_row.get("reaped") != 0:
        bad.append(("recovery", [(k, r.get("ok"), r.get("duplicates"),
                                  r.get("adopted")) for k, r in
                                 by_key.items()]))

    # the router in a process of its own, its replicas children of it
    port_file = out_dir / "router.port"
    env = dict(os.environ,
               TPU_REDUCTIONS_LEDGER=str(out_dir / "router.ledger.jsonl"))
    t0 = time.perf_counter()
    with open(out_dir / "router.log", "wb") as log:
        router = subprocess.Popen(
            [sys.executable, "-m", "tpu_reductions_torch.serve.router",
             "--replicas=2", "--port=0", f"--port-file={port_file}",
             "--max-seconds=300"], stdout=log, stderr=subprocess.STDOUT,
            env=env)
    try:
        while not (port_file.exists() and port_file.read_text().strip()):
            if router.poll() is not None or time.perf_counter() - t0 > 240:
                raise AssertionError(
                    "[fleet] the router did not start: "
                    + (out_dir / "router.log").read_text()[-2000:])
            time.sleep(0.1)
        print(f"  fleet router up in {time.perf_counter() - t0:.1f} s: "
              + (out_dir / "router.log").read_text().strip(), flush=True)
        # what each replica's context holds of the card while it serves
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"  fleet compute apps with the router up: {apps or 'none'}",
              flush=True)
        out = out_dir / "curve_router.json"
        rc, text, seconds = run_cli(loadgen.main, SERVE_LOOP + [
            f"--connect=127.0.0.1:{int(port_file.read_text())}",
            f"--out={out}"])
    finally:
        router.send_signal(2)        # SIGINT: the router reaps INT first
        try:
            router.wait(90)
        except subprocess.TimeoutExpired:
            router.kill()
            router.wait(30)
    rows = json.loads(out.read_text())["rows"]
    for r in rows:
        print(serve_row("int n=65536 (router, 2 process replicas)", r),
              flush=True)
    if rc != 0 or [(r["mode"], r["ok"]) for r in rows] != [("remote",
                                                             256)]:
        bad.append(("router", rc, router.returncode))

    # no process of the phase is left: not as a pid, not on the card
    pids = fleet_pids(out_dir)
    deadline = time.monotonic() + 30
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = set()
        for pid in pids:
            try:
                os.kill(pid, 0)
                alive.add(pid)
            except ProcessLookupError:
                pass
        time.sleep(0.2)
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout
    on_card = {int(line.split(",")[0]) for line in apps.splitlines()
               if line.strip() and line.split(",")[0].strip().isdigit()}
    print(f"  fleet processes: {len(pids)} pids of the phase, alive "
          f"{sorted(alive)}, on the card {sorted(on_card & pids)}; "
          f"compute apps now: {apps.strip() or 'none'}", flush=True)
    if not pids or alive or on_card & pids:
        bad.append(("orphans", sorted(alive), sorted(on_card & pids)))
    if bad:
        raise AssertionError(f"[fleet] not as required: {bad}")


# [resilience]: the watchdog, preflight, calibration, the scheduler and
# the flight recorder's analysis, each CLI in a process of its own
CAL_N = 1 << 24
HANG_N = 1 << 24
HANG_ITERS = 60000
RES_SMOKE_N = 1 << 19
RES_SPOT_N = 1 << 24
HANG_FAULT = json.dumps({"heartbeat.tick": {"action": "suppress"}})
# the budget of every task in the phase's two task files: the scheduler's
# input, which it plans from, ample for each task on the card
# redlint: disable=RED013 -- the scheduler's own input: the task files this phase hands to python -m tpu_reductions_torch.sched
TASK_BUDGET_S = 600
# the hang's deadline and the watchdog's cadence
HANG_ENV = {"TPU_REDUCTIONS_HEARTBEAT_DEADLINE_S": "2",
            "TPU_REDUCTIONS_WATCHDOG_INTERVAL_S": "0.5"}
# the stuck kernel: csrc/fault.cu's spin, launched by the spin fault at
# the first timed trip of the main CLI's chained k6 row (chain.step's
# third hit: the first two trips capture the row's graphs), for SPIN_S,
# far past the deadline
SPIN_S = 20
SPIN_FAULT = json.dumps({"chain.step": {"action": "spin",
                                        "seconds": SPIN_S, "after": 2,
                                        "times": 1}})
SPIN_ROW = ["tpu_reductions_torch", "--method=SUM", "--type=int",
            f"--n={HANG_N}", "--timing=chained", "--logfile="]


def run_module(argv, env, timeout=600) -> tuple[int, str, float]:
    """`python -m <argv>` in a process of its own: (exit code, its
    standard output and error, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *argv], env=env,
                       capture_output=True, text=True, timeout=timeout)
    return r.returncode, r.stdout + r.stderr, time.perf_counter() - t0


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def spin_rehearsal(env: dict, out_dir: Path) -> None:
    """The stuck kernel, after the hung plan: the main CLI's int32 SUM
    2^24 row through k6, chained, with the spin fault on its first timed
    trip, must exit 4 with a `watchdog.exit {code: 4, phase}` at most the
    phase's deadline plus two watchdog intervals after its `fault.fire`
    on the ledger's clock; its process must be gone, a fresh preflight
    must find the card LIVE, and the same row must then pass in a fresh
    process. Each figure on a line of its own."""
    from tpu_reductions_torch.obs import timeline

    led = Path(env["TPU_REDUCTIONS_LEDGER"])
    deadline = float(HANG_ENV["TPU_REDUCTIONS_HEARTBEAT_DEADLINE_S"])
    interval = float(HANG_ENV["TPU_REDUCTIONS_WATCHDOG_INTERVAL_S"])
    limit = deadline + 2 * interval
    before = len(timeline.read_ledger(led)[0]) if led.exists() else 0
    rc, text, sec = run_module(
        SPIN_ROW, {**env, **HANG_ENV, "TPU_REDUCTIONS_FAULTS": SPIN_FAULT},
        timeout=300)
    new = timeline.read_ledger(led)[0][before:]
    fires = [e for e in new if e["ev"] == "fault.fire"
             and e.get("point") == "chain.step" and e.get("action") == "spin"]
    exits = [e for e in new if e["ev"] == "watchdog.exit"]
    print(f"  stuck kernel: exit {rc} in {sec:.1f} s", flush=True)
    print(f"  stuck kernel's fault.fire: {fires[-1] if fires else None}",
          flush=True)
    print(f"  stuck kernel's watchdog.exit: {exits[-1] if exits else None}",
          flush=True)
    if rc != 4 or len(fires) != 1 or len(exits) != 1 \
            or exits[0]["code"] != 4 or not exits[0].get("phase"):
        raise AssertionError(f"[resilience] the stuck kernel: {text[-3000:]}")
    took = exits[0]["t"] - fires[0]["t"]
    print(f"  stuck kernel: fault.fire to watchdog.exit {took:.3f} s "
          f"(limit {limit:.1f} s: deadline {deadline:.1f} s plus two "
          f"intervals), phase {exits[0]['phase']!r}", flush=True)
    pid = fires[0]["pid"]
    print(f"  stuck kernel's process {pid} alive: {pid_alive(pid)}",
          flush=True)
    if took > limit or pid_alive(pid):
        raise AssertionError(f"[resilience] the stuck kernel's exit took "
                             f"{took:.3f} s (limit {limit} s), or its "
                             f"process {pid} survives")
    rc, text, sec = run_module(["tpu_reductions_torch.utils.preflight"], env)
    health = json.loads((out_dir / "health.json").read_text())
    print(f"  preflight after the stuck kernel: exit {rc}, "
          f"{health['verdict']} in {health['elapsed_s']} s ({sec:.1f} s "
          "with the CLI)", flush=True)
    if rc != 0 or health["verdict"] != "LIVE":
        raise AssertionError(f"[resilience] preflight after the stuck "
                             f"kernel: {text[-2000:]}")
    rc, text, sec = run_module(SPIN_ROW, {**env, **HANG_ENV})
    passed = "&&&& tpu_reductions_torch PASSED" in text
    print(f"  the same row after the stuck kernel: exit {rc} in {sec:.1f} s, "
          f"{'PASSED' if passed else 'not PASSED'}", flush=True)
    if rc != 0 or not passed:
        raise AssertionError(f"[resilience] the row after the stuck "
                             f"kernel: {text[-3000:]}")


def resilience_path(driver, counted, kr, registry, config, staging) -> None:
    """[resilience] into out/smoke_resilience, one ledger for all:
    preflight LIVE; the scheduler's plan of four card tasks (smoke,
    spot, the calibration ladder, warm) to completion, the ladder's five
    times a rung and its verdict printed; a plan whose hung task the
    watchdog ends with exit 4, and its resume, the same row passing
    watched; a stuck kernel that the watchdog ends with exit 4
    (spin_rehearsal); no process left; and the analysis of the
    ledger."""
    from tpu_reductions_torch.obs import critical_path, timeline
    from tpu_reductions_torch.obs.compile import CompileModel
    from tpu_reductions_torch.obs.trace_export import chrome_trace
    from tpu_reductions_torch.sched.priors import Priors
    from tpu_reductions_torch.sched.tasks import Task
    from tpu_reductions_torch.utils.jsonio import atomic_json_dump

    out_dir = (OUT / "smoke_resilience").resolve()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    led = out_dir / "ledger.jsonl"
    env = {**os.environ, "TPU_REDUCTIONS_LEDGER": str(led),
           "TPU_REDUCTIONS_HEALTH_FILE": str(out_dir / "health.json")}
    env.pop("TPU_REDUCTIONS_FAULTS", None)

    def events() -> list:
        return timeline.read_ledger(led)[0]

    # 1. preflight
    rc, text, sec = run_module(["tpu_reductions_torch.utils.preflight"], env)
    health = json.loads((out_dir / "health.json").read_text())
    print(f"  preflight: exit {rc}, {health['verdict']} in "
          f"{health['elapsed_s']} s ({sec:.1f} s with the CLI): "
          f"{health['detail']}", flush=True)
    if rc != 0 or health["verdict"] != "LIVE":
        raise AssertionError(f"[resilience] preflight: {text[-2000:]}")

    # 2. the scheduler: four card tasks to a complete plan, the third the
    # calibration ladder
    m = f"{sys.executable} -m tpu_reductions_torch"
    cal_out = out_dir / "calibration.json"
    ledger_json = out_dir / "compile_ledger.json"
    tasks = [
        dict(name="smoke", value=4, budget_s=TASK_BUDGET_S,
             command=f"{m}.bench.smoke --n={RES_SMOKE_N} "
                     f"--out={out_dir}/smoke.json",
             done_artifact=f"{out_dir}/smoke.json"),
        dict(name="spot", value=3, budget_s=TASK_BUDGET_S,
             command=f"{m}.bench.spot --type=int --n={RES_SPOT_N} "
                     f"--iterations=32 --chainreps=2 "
                     f"--out={out_dir}/spot.json",
             done_artifact=f"{out_dir}/spot.json"),
        dict(name="calibrate", value=2, budget_s=TASK_BUDGET_S,
             command=f"{m}.utils.calibrate --ladder --n={CAL_N} "
                     f"--out={cal_out}",
             done_artifact=str(cal_out), surfaces=["torch"]),
        dict(name="warm", value=1, budget_s=TASK_BUDGET_S,
             command=f"{m}.bench.warm --only=nvcc,k6,dd "
                     f"--out={ledger_json}",
             done_artifact=str(ledger_json), surfaces=["nvcc"])]
    atomic_json_dump(out_dir / "tasks.json", tasks)
    state = out_dir / "sched_state.json"
    rc, text, sec = run_module(
        ["tpu_reductions_torch.sched", f"--tasks={out_dir}/tasks.json",
         f"--state={state}", f"--compile-ledger={ledger_json}"], env)
    st = json.loads(state.read_text())
    per_task = {k: (v["status"], v.get("actual_s"))
                for k, v in st["tasks"].items()}
    print(f"  sched: exit {rc} in {sec:.1f} s, complete {st['complete']}, "
          f"tasks {per_task}", flush=True)
    if rc != 0 or st["complete"] is not True \
            or sorted(v[0] for v in per_task.values()) != ["done"] * 4:
        raise AssertionError(f"[resilience] sched: {text[-3000:]}")
    cal = json.loads(cal_out.read_text())
    for rung in cal["rungs"]:
        print("  calibrate n={n} {dtype}: single {s:.2f} us, amortized "
              "{a:.2f} us/iter, round trip {r:.2f} us, chained {c:.2f} "
              "us/iter ({g:.1f} GB/s), post-fetch {p:.2f} us".format(
                  n=rung["n"], dtype=rung["dtype"],
                  s=rung["single_blocked_s"] * 1e6,
                  a=rung["amortized_blocked_s"] * 1e6,
                  r=rung["roundtrip_s"] * 1e6,
                  c=rung["chained_per_iter_s"] * 1e6,
                  g=rung["honest_gbps"] or 0.0,
                  p=rung["post_fetch_single_blocked_s"] * 1e6), flush=True)
    print(f"  calibrate verdict: block_awaits_execution="
          f"{cal['block_awaits_execution']} (indeterminate "
          f"{cal['indeterminate']}, deciding n={cal['deciding_n']})",
          flush=True)
    if not cal["complete"] or len(cal["rungs"]) != 2:
        raise AssertionError(f"[resilience] calibration: {cal}")

    # 3. the hang, as the second task of a plan: the main CLI's row with
    # the heartbeat's marks frozen must exit 4 with its watchdog.exit,
    # the plan with it; rerun without the fault, the plan resumes with
    # the hung task, whose row then passes, watched, and the one after
    hang_cmd = " ".join([
        sys.executable, "-m", "tpu_reductions_torch", "--method=SUM",
        "--type=int", f"--n={HANG_N}", f"--iterations={HANG_ITERS}",
        "--logfile="])
    # one budget for all three, so the plan runs them in value order
    window = [dict(name="before", value=3, budget_s=TASK_BUDGET_S, command="true"),
              dict(name="hang_probe", value=2, budget_s=TASK_BUDGET_S,
                   command=hang_cmd),
              dict(name="after", value=1, budget_s=TASK_BUDGET_S, command="true")]
    atomic_json_dump(out_dir / "window.json", window)
    wstate = out_dir / "window_state.json"
    wsched = ["tpu_reductions_torch.sched", f"--tasks={out_dir}/window.json",
              f"--state={wstate}"]
    rc, text, sec = run_module(
        wsched, {**env, **HANG_ENV, "TPU_REDUCTIONS_FAULTS": HANG_FAULT})
    st = json.loads(wstate.read_text())
    print(f"  sched with the hang: exit {rc} in {sec:.1f} s, complete "
          f"{st['complete']}, tasks "
          f"{ {k: v['status'] for k, v in st['tasks'].items()} }",
          flush=True)
    exits = [e for e in events() if e["ev"] == "watchdog.exit"]
    print(f"  the hang's watchdog.exit: {exits[-1] if exits else None}",
          flush=True)
    if rc != 4 or st["complete"] is not False \
            or sorted(st["tasks"]) != ["before", "hang_probe"] \
            or st["tasks"]["before"]["status"] != "done" \
            or st["tasks"].get("hang_probe", {}).get("status") != "aborted" \
            or not exits or exits[-1]["code"] != 4 \
            or not exits[-1].get("phase"):
        raise AssertionError(f"[resilience] the hung plan: {text[-3000:]}")
    before = len(events())
    rc, text, sec = run_module(wsched, {**env, **HANG_ENV})
    st = json.loads(wstate.read_text())
    picks = [e["task"] for e in events()[before:]
             if e["ev"] == "sched.pick"]
    print(f"  sched resumed: exit {rc} in {sec:.1f} s, complete "
          f"{st['complete']}, picked {picks}", flush=True)
    if rc != 0 or st["complete"] is not True \
            or picks != ["hang_probe", "after"] \
            or st["tasks"]["hang_probe"]["rc"] != 0 \
            or text.count("&&&& tpu_reductions_torch PASSED") != 1:
        raise AssertionError(f"[resilience] the resume: {text[-3000:]}")

    # 3b. a kernel that does not return: the card's own hang
    spin_rehearsal(env, out_dir)

    # every process of the phase has ended
    evs, torn = timeline.read_ledger(led)
    pids = {e["pid"] for e in evs} - {os.getpid()}
    alive = sorted(p for p in pids if pid_alive(p))
    print(f"  processes of the phase: {len(pids)}, alive {alive}",
          flush=True)
    if alive:
        raise AssertionError(f"[resilience] processes survive: {alive}")

    # 4. the analysis of the phase's ledger
    summary = timeline.summarize(led, evs, torn)
    for sess in summary["sessions"]:
        total = sum(sess["phases_s"].values())
        if abs(total - sess["wall_s"]) > 0.01 * max(sess["wall_s"], 1e-3):
            raise AssertionError(f"[resilience] session {sess['pid']}: "
                                 f"buckets {total} vs {sess['wall_s']} s")
    win = summary["window"]
    if abs(sum(win["phases_s"].values()) - win["recorded_s"]) \
            > 0.01 * win["recorded_s"]:
        raise AssertionError("[resilience] the window's buckets do not "
                             "sum to its recorded seconds")
    stalled = [s for s in summary["sessions"] if s["end"] == "exit 4"]
    if len(stalled) < 1 or not all(s["phases_s"]["stalled"] > 0
                                   for s in stalled):
        raise AssertionError(f"[resilience] the exit-4 stalls are not in "
                             f"'stalled': {stalled}")
    print(f"  timeline: {len(evs)} events, {torn} torn, "
          f"{len(summary['sessions'])} sessions; window "
          f"{win['recorded_s']:.2f} s recorded: " + ", ".join(
              f"{k} {v:.2f} s ({win['utilization'][k]:.0%})"
              for k, v in win["phases_s"].items()), flush=True)
    doc = json.loads(json.dumps(chrome_trace(evs)))
    lanes = {e["pid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    procs = {e["pid"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    sessions = {s["pid"] for s in summary["sessions"]}
    print(f"  chrome trace: {len(doc['traceEvents'])} trace events, "
          f"slices in {len(lanes)} processes, {len(procs)} named; "
          f"{len(sessions)} sessions", flush=True)
    if not sessions <= procs or not lanes:
        raise AssertionError("[resilience] the trace lacks a lane for a "
                             "process")
    cp = critical_path.compute(evs)
    print(f"  critical path over {cp['wall_s']:.2f} s: {cp['chain']}",
          flush=True)
    rows = json.loads(ledger_json.read_text())["surfaces"]
    build = {r["verdict"]: r["dur_s"] for r in rows
             if r["surface"] == "nvcc"}
    priors = Priors.from_ledgers([str(led)], compile_ledger=str(ledger_json),
                                 platform="gpu")
    # redlint: disable=RED013 -- a probe Task for priors.estimate, whose printed estimate is what the phase checks; it plans nothing
    probe = Task(name="build", title="build", value=1.0, budget_s=60.0,
                 command="true", artifacts=(), surfaces=("nvcc",))
    model = CompileModel.from_file(str(ledger_json), platform="gpu")
    # redlint: disable=RED013 -- probe Tasks for priors.estimate's history; they plan nothing
    history = {k: round(priors.estimate(Task(
        name=k, title=k, value=1, budget_s=1, command="", artifacts=())), 3)
        for k in ("smoke", "spot", "calibrate", "warm")}
    print(f"  compile ledger: build rows {build}; priors: nvcc "
          f"{priors.compile_status(probe)}, banked "
          f"{model.saved_s(['nvcc']):.2f} s, a 60 s build task estimated "
          f"{priors.estimate(probe):.2f} s; sched history {history}",
          flush=True)
    if set(build) != {"cold", "warm"} \
            or priors.compile_status(probe) != "warm":
        raise AssertionError(f"[resilience] compile ledger rows {rows}")


# [multicard]: the collective CLI with one process a card, P = min(4,
# cards), NCCL between them, each row held against its one-card twin
MC_MAX_P = 4
MC_RETRIES = 3
MC_TIMEOUT_S = 420
MC_OUT = OUT / "smoke_multicard"
# what the last [multicard] ran: the `kernels` line's note
MULTICARD = {"ran": False, "processes": 1, "backend": "nccl",
             "why": "not reached"}


def multicard_rows(p: int) -> list:
    """(argv, label) of every [multicard] row at P cards: the reduce.c grid
    at k = P (a rank a card) and k = 2P (two, so hops inside a card and
    across cards mix), periter and chained, at COLL_N; SUM and MIN
    scattered and rooted at k = 2P; the pair route (dd SUM, key MIN/MAX)
    at PAIR_N, periter and chained; float32 SUM on the 8-bit quantized
    ring, chained."""
    rows = []
    timed = [f"--retries={MC_RETRIES}", f"--chainspan={COLL_SPAN}"]
    for k in (p, 2 * p):
        for dtype in ("int", "double"):
            for method in METHODS:
                for timing in ("periter", "chained"):
                    rows.append(([f"--method={method}", f"--type={dtype}",
                                  f"--n={COLL_N}", f"--devices={k}",
                                  f"--timing={timing}"] + timed,
                                 "all_reduce"))
    for method, rooted, label in (("SUM", "scatter", "reduce_scatter"),
                                  ("MIN", "scatter", "reduce_scatter"),
                                  ("SUM", "root", "reduce_to_root_rs_ag"),
                                  ("MIN", "root", "reduce_to_root_rs_ag")):
        rows.append(([f"--method={method}", "--type=int", f"--n={COLL_N}",
                      f"--devices={2 * p}", f"--rooted={rooted}"] + timed,
                     label))
    for method, label in (("SUM", "dd_ring_rs_ag"),
                          ("MIN", "key_two_phase_all_reduce"),
                          ("MAX", "key_two_phase_all_reduce")):
        for timing in ("periter", "chained"):
            rows.append(([f"--method={method}", "--type=double", "--f64=dd",
                          f"--n={PAIR_N}", f"--devices={2 * p}",
                          f"--timing={timing}"] + timed, label))
    rows.append((["--method=SUM", "--type=float", "--quantized",
                  "--quant-bits=8", f"--n={COLL_N}", f"--devices={2 * p}",
                  "--timing=chained"] + timed, "q8_ring_rs_ag"))
    return rows


def _median(xs) -> float:
    return statistics.median(xs) if xs else 0.0


def _cli_across_cards(p: int) -> list:
    """The collective CLI itself, P processes on P cards (int32 SUM at
    k = 2P): every process exits 0, rank 0 prints the placement note, its
    rows, each row's NVLink share and PASSED; returns the survivors and
    what failed (None when nothing did)."""
    from tpu_reductions_torch.bench.multicard import free_port, run_group
    port = free_port()
    argv = ["--method=SUM", "--type=int", f"--n={COLL_N}",
            f"--devices={2 * p}", "--retries=2", f"--num-processes={p}",
            f"--coordinator=127.0.0.1:{port}"]
    group = run_group(
        [[sys.executable, "-m", "tpu_reductions_torch.bench.collective_driver",
          *argv, f"--process-id={i}"] for i in range(p)], 240)
    outs, rcs = group["outs"], group["rcs"]
    out0 = outs[0][0]
    print("  " + out0.replace("\n", "\n  ").rstrip(), flush=True)
    if (rcs != [0] * p or f"lie on {p} cards" not in out0
            or "x NVLink's 450 GB/s each way" not in out0
            or "&&&& tpu_reductions_torch.collective PASSED" not in out0
            or any(o.strip() for o, _ in outs[1:])):
        return group["survivors"], (
            f"the CLI across {p} cards: exit {rcs}; "
            f"{[e[-2000:] for _, e in outs]}")
    return group["survivors"], None


def _chain_note(mc, tw, recs, head) -> tuple:
    """(ok, words): a chained row's timed chain scalar in the workers
    against its one-card twin's, the same bits where the row must keep
    them, else within registry.tolerance: process 0's always (it holds
    rank 0, the twin's first row), every process's where the output is
    replicated. Each process already held its graph's scalar against the
    chain run one by one (collective_driver)."""
    exact = mc.bits_required(head["method"], head["dtype"],
                             head["algorithm"])
    held = [rec for j, rec in enumerate(recs) if j == 0 or rec["replicated"]]
    ok = tw["chain"] is not None and all(
        rec.get("chain") and mc.chain_agrees(
            mc.chain_scalar(rec), tw["chain"], exact, head["method"],
            head["dtype"], head["n"]) for rec in held)
    how = "same bits" if exact else "within registry.tolerance"
    return ok, (f"chain scalar of {len(held)} process(es) {how} as one "
                f"card's" if ok else "CHAIN SCALAR DIFFERS from one card's")


# the sharded serving part of [multicard]: the executor's shard route over
# the host's cards at the fleet's sharded row (loadgen --sharded-n, 640 MB
# of int32), each row beside its one-card twin (cards=[cuda:0])
SHARD_N = 160_000_000
SHARD_ROWS = (("SUM", "int32", False), ("MIN", "int32", False),
              ("MAX", "int32", False), ("SUM", "float32", False),
              ("SUM", "bfloat16", False), ("SUM", "float32", True))
SHARD_QUANT_BITS = 8
# the front end's two oversized requests: int32 and float32 SUM
SHARD_REQUESTS = ({"method": "SUM", "type": "int", "n": SHARD_N, "seed": 1},
                  {"method": "SUM", "type": "float", "n": SHARD_N,
                   "seed": 2})


def _timed_shard(ex, method, dtype, quantized, seed):
    """(response, host seconds, last_shard) of one run_sharded call."""
    t0 = time.perf_counter()
    res = ex.run_sharded(method, dtype, SHARD_N, seed, quantized=quantized,
                         quant_bits=SHARD_QUANT_BITS)
    return res, time.perf_counter() - t0, dict(ex.last_shard)


def _shard_rows(c: int) -> list:
    """The executor's rows at K = C and 2C over C cards, each beside its
    one-card twin: every row ok, with the twin's algorithm and bits,
    `cards` C against the twin's 1; prints each row's latency and steps,
    each partial's card, each card's chunks and how its partials reached
    cuda:0. Returns what failed."""
    from tpu_reductions_torch.device import rank_blocks
    from tpu_reductions_torch.serve.executor import BatchExecutor
    lead = torch.device("cuda", 0)
    bad = []
    # every row's ops and combine once at 2^22 over the cards first: the
    # cards' contexts and each op's first load on each card stay out of
    # the timed rows, as they are out of the twins' (cuda:0 ran them)
    t0 = time.perf_counter()
    for k in (c, 2 * c):
        for method, dtype, quantized in SHARD_ROWS:
            BatchExecutor("gpu", ranks=k).run_sharded(
                method, dtype, 1 << 22, 0, quantized=quantized,
                quant_bits=SHARD_QUANT_BITS)
    print(f"  sharded: warm-up of every row at n = 2^22 over {c} cards "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for k in (c, 2 * c):
        for seed, (method, dtype, quantized) in enumerate(SHARD_ROWS):
            got, lat, steps = _timed_shard(BatchExecutor("gpu", ranks=k),
                                           method, dtype, quantized, seed)
            want, twin_lat, twin_steps = _timed_shard(
                BatchExecutor("gpu", ranks=k, cards=[lead]), method, dtype,
                quantized, seed)
            same = (got["result"] == want["result"]
                    and got["host"] == want["host"])
            label = (f"{dtype} {method}{' q8' if quantized else ''} k={k} "
                     f"n={SHARD_N}")
            folds = ", ".join(f"{s:.4f}" for s in steps["fold_cards"])
            print(f"  sharded {label}: {got['algorithm']} ok={got['ok']} "
                  f"cards={got['cards']} latency {lat:.4f} s (fill "
                  f"{steps['fill']:.4f}, fold {steps['fold']:.4f} [cards "
                  f"{folds}], gather {steps['gather']:.6f}, combine "
                  f"{steps['combine']:.4f}, verify {steps['verify']:.4f}); "
                  f"one card {twin_lat:.4f} s (fill "
                  f"{twin_steps['fill']:.4f}, fold "
                  f"{twin_steps['fold']:.4f}; ratio {lat / twin_lat:.3f}); "
                  f"{'same bits' if same else 'BITS DIFFER'} as one card "
                  f"({got['result']!r} vs {want['result']!r})\n"
                  f"    partials on {got['partials_on']}; chunks a card "
                  f"{got['card_chunks']}; gather {got['gather_route']}; "
                  f"{got['note']}", flush=True)
            if not (got["ok"] and want["ok"] and same
                    and got["algorithm"] == want["algorithm"]
                    and got["cards"] == c and want["cards"] == 1
                    and got["partials_on"] == [
                        f"cuda:{i}" for i, b in enumerate(
                            rank_blocks(k, c)) for _ in b]):
                bad.append(("sharded", label, got["ok"], want["ok"], same,
                            got["algorithm"], want["algorithm"],
                            got["cards"]))
    return bad


def _shard_front_end(c: int) -> list:
    """`python -m tpu_reductions_torch.serve --devices=2C` in a process of
    its own on the C cards: both SHARD_REQUESTS answered ok with `cards`
    C and a `serve.shard` event each; the process gone afterwards.
    Returns what failed."""
    out_dir = (MC_OUT / "front_end").resolve()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    port_file, led = out_dir / "port", out_dir / "ledger.jsonl"
    env = dict(os.environ, TPU_REDUCTIONS_LEDGER=str(led))
    bad, answers = [], []
    t0 = time.perf_counter()
    with open(out_dir / "serve.log", "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_reductions_torch.serve",
             f"--devices={2 * c}", "--port=0", f"--port-file={port_file}",
             "--max-seconds=300"], stdout=log, stderr=subprocess.STDOUT,
            env=env)
    try:
        while not (port_file.exists() and port_file.read_text().strip()):
            if proc.poll() is not None or time.perf_counter() - t0 > 120:
                raise AssertionError(
                    "[multicard] the front end did not start: "
                    + (out_dir / "serve.log").read_text()[-2000:])
            time.sleep(0.1)
        up = time.perf_counter() - t0
        port = int(port_file.read_text())
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            rfile = s.makefile("rb")
            for req in SHARD_REQUESTS:
                r0 = time.perf_counter()
                s.sendall((json.dumps(req) + "\n").encode())
                answers.append((json.loads(rfile.readline()),
                                time.perf_counter() - r0))
    finally:
        proc.send_signal(2)          # SIGINT: the front end's own stop
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
    events = [json.loads(line) for line in led.read_text().splitlines()
              if line.strip()]
    shards = [e for e in events if e.get("ev") == "serve.shard"]
    for (resp, sec), req in zip(answers, SHARD_REQUESTS):
        print(f"  front end --devices={2 * c}: {req['type']} SUM "
              f"n={req['n']}: {resp.get('status')} cards={resp.get('cards')} "
              f"latency {resp.get('latency_s')} s ({sec:.4f} s on the "
              f"socket)", flush=True)
    alive = pid_alive(proc.pid)
    print(f"  front end up in {up:.1f} s, exit {proc.returncode}; "
          f"serve.shard events {[e.get('cards') for e in shards]}; pid "
          f"{proc.pid} alive: {alive}", flush=True)
    if (len(answers) != len(SHARD_REQUESTS)
            or any(r.get("status") != "ok" or r.get("cards") != c
                   for r, _ in answers)
            or len(shards) != len(SHARD_REQUESTS)
            or any(e.get("cards") != c for e in shards) or alive):
        bad.append(("front end", [r for r, _ in answers],
                    [e.get("cards") for e in shards], alive))
    return bad


def sharded_serving(c: int) -> list:
    """[multicard]'s sharded serving part on C cards: the executor's rows
    and the TCP front end. It launches no kernel of the repository: the
    shard fold and the combine are torch ops, as the JAX route's are jnp
    under jit and an XLA collective. Returns what failed."""
    t0 = time.perf_counter()
    bad = _shard_rows(c) + _shard_front_end(c)
    print(f"  sharded serving part: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return bad


# the ladder part of [multicard]: bench.rank_scaling across the P cards
# (each rung's ranks on min(k, P) cards, one process a card, NCCL between
# them) beside its one-card twin (--cards=1 on cuda:0); the sweep at the
# [rank_scaling] phase's n with rung 4 added (one or two ranks a card at
# 2, 4 and 8), the curves over the rungs where a card holds one or two
MC_LADDER_KS = (2, 4, 8, 64, 1024)
MC_CURVE_KS = (2, 4, 8)
MC_LADDER_OUT = OUT / "smoke_multicard_ladder"
MC_LADDER_QUANT_CELLS = 51
MC_LADDER_RESHARD_CELLS = 21


def _ladder(cards: int, where: str):
    """bench.rank_scaling at the ladder part's settings on `cards` cards
    (one process a card past one), a Witness recording every row's
    output; returns (its result, host seconds)."""
    from tpu_reductions_torch.bench import multicard, rank_scaling
    from tpu_reductions_torch.utils.logging import BenchLogger
    t0 = time.perf_counter()
    log = io.StringIO()
    try:
        # redlint: disable=RED018 -- the ladder's host seconds against the phase's time limit; its rows carry the device times
        res = rank_scaling.run_rank_scaling(
            MC_LADDER_OUT / where, ranks=MC_LADDER_KS, n=LADDER_N,
            retries=1, curve_n=1 << 24, rows=4096,
            curve_ranks=MC_CURVE_KS, platform="gpu", cards=cards,
            witness=multicard.Witness(MC_LADDER_OUT / f"evidence_{where}"),
            logger=BenchLogger(None, None, console=log))
    finally:
        (MC_LADDER_OUT / f"{where}.log").write_text(log.getvalue())
    return res, time.perf_counter() - t0


def ladder_across_cards(p: int) -> list:
    """[multicard]'s ladder part: bench.rank_scaling with --cards=P (the
    sweep at 2^26, int32 and float64 x MAX/MIN/SUM, one retry, over ranks
    2, 4, 8, 64 and 1024; the amortisation probe at 1024; the quantized
    and reshard curves at 2^24 over ranks 2, 4 and 8), then the same at
    --cards=1 on cuda:0 as its twin. Every row PASSED in both, the same
    count of quant and reshard cells, every row with one card's bits or
    within registry.tolerance (bench/multicard.ladder_agrees: the same
    bits for int32, MIN/MAX, the quantized rings and the reshard programs
    that only move data), each reshard row's accounted memory factor
    within its declared one, the k = 2 rung on two cards, no worker
    alive; prints each rung's ms, GB/s, busbw a card against NVLink, the
    twin's ms and the ratio, and both runs' stage seconds. Returns what
    failed. The ladder launches no kernel of the repository."""
    import types
    from tpu_reductions_torch.bench import multicard
    shutil.rmtree(MC_LADDER_OUT, ignore_errors=True)
    MC_LADDER_OUT.mkdir(parents=True)
    bad = []
    try:
        ladder, ladder_s = _ladder(p, "cards")
    except multicard.LadderFailed as e:
        return [("ladder", f"exit {e.code}", str(e)[-3000:])]
    twin, twin_s = _ladder(1, "twin")
    print(f"  ladder part: {ladder_s + twin_s:.1f} s; across {p} cards "
          f"{ladder_s:.1f} s (stages {ladder['seconds']}); its one-card "
          f"twin {twin_s:.1f} s (stages {twin['seconds']}); no worker "
          f"alive", flush=True)
    shape = ladder["shape"]
    print(f"  ranks a card: {shape.get('ranks_a_card')}; note: "
          f"{shape['note']}", flush=True)
    twins = {(r["ranks"], r["dtype"], r["method"], r["repeat"]): r
             for r in twin["sweep"]}
    for r in ladder["sweep"]:
        tw = twins.get((r["ranks"], r["dtype"], r["method"], r["repeat"]))
        bound_ms = collective_bound_ms(types.SimpleNamespace(**r))
        ratio = r["time_s"] / tw["time_s"] if tw and tw["time_s"] else 0.0
        share = r.get("nvlink_share")
        print(f"  ladder {r['dtype']} {r['method']} k={r['ranks']} on "
              f"{r.get('cards')} cards: {r['algorithm']} "
              f"{1e3 * r['time_s']:.5f} ms, {r['reference_gbps']:.4f} "
              f"GB/s, busbw {r['busbw_gbps']:.4f} "
              f"({r.get('busbw_per_card_gbps', 0.0):.4f} a card, "
              + (f"{share:.4f}x NVLink" if share is not None
                 else "no link share") + "), "
              f"bound {bound_ms:.5f} ms; one card "
              f"{1e3 * tw['time_s'] if tw else float('nan'):.5f} ms (ratio "
              f"{ratio:.3f}) [{r['status']}, twin "
              f"{tw['status'] if tw else 'MISSING'}]", flush=True)
        if (r["status"] != "PASSED" or tw is None
                or tw["status"] != "PASSED"
                or r.get("cards") != min(r["ranks"], p)):
            bad.append(("ladder sweep", r["ranks"], r["dtype"], r["method"],
                        r["status"], r.get("cards")))
    print(f"  amortisation probe at k={shape['amortization_probe_ranks']}:"
          f" {shape['amortization_probe']} (one card "
          f"{twin['shape']['amortization_probe']})", flush=True)
    quant, reshard = ladder["quant"], ladder["reshard"]
    tw_reshard = {(r["pair"], r["wire"], r["ranks"]): r
                  for r in twin["reshard"]}
    for r in reshard:
        tw = tw_reshard.get((r["pair"], r["wire"], r["ranks"]), {})
        print(f"  ladder reshard {r['pair']} {r['wire']} k={r['ranks']} "
              f"[{'+'.join(r['program'])}] {1e3 * r['wall_s']:.5f} ms, "
              f"{r['gbps']:.3f} GB/s; one card "
              f"{1e3 * tw.get('wall_s', float('nan')):.5f} ms; mem "
              f"accounted/declared {r['measured_mem_factor']}/"
              f"{r['mem_factor']}, largest card peak "
              f"{r['device_mem_factor']} (one card "
              f"{tw.get('device_mem_factor')}) [{r['status']}]", flush=True)
    q_worst = max((r["max_err"] / r["bound"] for r in quant
                   if r["bound"] > 0), default=0.0)
    print(f"  ladder quant_curve: {len(quant)} cells "
          f"{sorted({r['status'] for r in quant})}, worst err/bound "
          f"{q_worst:.3f}; one card {len(twin['quant'])} cells", flush=True)
    if (len(quant) != MC_LADDER_QUANT_CELLS
            or len(twin["quant"]) != len(quant)
            or len(reshard) != MC_LADDER_RESHARD_CELLS
            or len(twin["reshard"]) != len(reshard)
            or ladder["probe_dropped"] or twin["probe_dropped"]
            or len(shape["amortization_probe"]) != 3):
        bad.append(("ladder cells", len(quant), len(twin["quant"]),
                    len(reshard), len(twin["reshard"]),
                    ladder["probe_dropped"], twin["probe_dropped"]))
    bad += [("ladder cell", r.get("pair") or r.get("method"),
             r.get("wire") or r.get("dtype"), r["ranks"], r["status"])
            for r in quant + reshard + twin["quant"] + twin["reshard"]
            if r["status"] != "PASSED"]
    bad += [("ladder reshard memory", r["pair"], r["wire"], r["ranks"])
            for r in reshard if r["measured_mem_factor"] > r["mem_factor"]]
    verdicts = multicard.ladder_agrees(MC_LADDER_OUT / "evidence_cards",
                                       MC_LADDER_OUT / "evidence_twin")
    counts: dict = {}
    for stage, key, ok, words in verdicts:
        rule = "same bits" if "bits" in words else "registry.tolerance"
        counts[(stage, rule)] = counts.get((stage, rule), 0) + 1
        if not ok:
            bad.append(("ladder twin", stage, key, words))
            print(f"  twin check {stage} {key}: {words}", flush=True)
        elif rule != "same bits":
            print(f"  twin check {stage} {key}: {words}", flush=True)
    print("  twin check: " + "; ".join(
        f"{stage} {n} row(s) by {rule}"
        for (stage, rule), n in sorted(counts.items())), flush=True)
    # the kept views are large (float64 SUM at 2^26): gone once checked
    for npy in MC_LADDER_OUT.glob("evidence_*/*.npy"):
        npy.unlink()
    return bad


def multicard_path(driver, counted, kr, registry, config, staging) -> None:
    """[multicard]: with 2 or more cards, the collective CLI across P =
    min(4, cards) cards, one process a card over NCCL, then every
    multicard_rows row in P workers (bench/multicard.launch) and beside
    it its one-card twin, the same k and n in this process on card 0:
    every row PASSED with its label in every process and in the twin;
    the same bits as the twin for every int32 and MIN/MAX row and the ring
    paths, float SUM through psum within the registry's tolerance of it;
    a chained row's graph scalar that of the chain run one by one (in
    each worker) and the twin's (_chain_note); each row printed with its GB/s, busbw, busbw a card against NVLink's
    450 GB/s each way, the twin's time and the ratio; the topology; no
    process of the phase alive afterwards; then the sharded serving part
    (sharded_serving). With one card it says so and runs nothing. The
    collectives launch no kernel of the repository."""
    from tpu_reductions_torch.bench import multicard as mc
    from tpu_reductions_torch.bench.collective_driver import NVLINK_GBPS
    cards = torch.cuda.device_count()
    if cards < 2:
        MULTICARD.update(ran=False, processes=1,
                         why=f"{cards} card (needs 2 or more)")
        print(f"  [multicard] did not run: {cards} card; the rank axis "
              f"across cards needs 2 or more", flush=True)
        return
    p = min(MC_MAX_P, cards)
    MULTICARD.update(ran=False, processes=p, why="running")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    topo = (topo.stdout + topo.stderr).rstrip()
    # the peer access the processes' copies can take, whatever topo says
    peers = "\n".join(
        f"  cuda:{i} peer access: " + " ".join(
            "-" if i == j else
            ("yes" if torch.cuda.can_device_access_peer(i, j) else "no")
            for j in range(cards)) for i in range(cards))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout
    nccl = torch.cuda.nccl.version()
    print(f"  {cards} cards, P = {p} processes over NCCL "
          f"{nccl if isinstance(nccl, int) else '.'.join(map(str, nccl))}\n"
          f"  {smi.strip()}\n  nvidia-smi topo -m: {topo}\n{peers}",
          flush=True)
    t0 = time.perf_counter()
    cli_survivors, cli_fault = _cli_across_cards(p)
    print(f"  the CLI across {p} cards: {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows = multicard_rows(p)
    t0 = time.perf_counter()
    run = mc.launch([argv for argv, _ in rows], p, MC_OUT,
                    timeout_s=MC_TIMEOUT_S)
    print(f"  {len(rows)} rows in {p} workers: {run['seconds']:.1f} s, "
          f"exit {run['rcs']}", flush=True)
    survivors = run["survivors"] + cli_survivors
    tails = [(MC_OUT / f"process{i}.log").read_text()[-3000:]
             for i in range(p)]
    if run["rcs"] != [0] * p or survivors or any(
            len(r) != len(rows) for r in run["records"]):
        raise AssertionError(f"[multicard] workers exit {run['rcs']}, "
                             f"survivors {survivors}: {tails}")
    bad = [cli_fault] if cli_fault else []
    twin_s = 0.0
    # the twins run as the workers ran the rows: a row's periter and
    # chained timings over one payload, warm-up and oracle
    twins = mc.twins([argv for argv, _ in rows])
    for i, (argv, label) in enumerate(rows):
        recs = [r[i] for r in run["records"]]
        tw = next(twins)
        twin_s += tw["seconds"]
        errors = [rec["error"] for rec in recs if "error" in rec]
        if errors:
            print(f"  {' '.join(argv)}: ERROR {errors[0]}", flush=True)
            bad.append((argv, errors))
            continue
        mine = recs[0]["results"]
        head = mine[0]
        statuses = {r["status"] for rec in recs for r in rec["results"]}
        statuses |= {r["status"] for r in tw["results"]}
        algs = {r["algorithm"] for rec in recs for r in rec["results"]}
        algs |= {r["algorithm"] for r in tw["results"]}
        if mc.bits_required(head["method"], head["dtype"], head["algorithm"]):
            same = mc.same_bits(tw["views"], recs)
            bits = "same bits" if same else "BITS DIFFER"
        else:
            same, diff = mc.within_tolerance(
                tw["views"], run["kept"][i], head["method"], head["dtype"],
                head["n"])
            bits = (f"max |diff| {diff:.3e} vs one card, within "
                    f"registry.tolerance" if same else
                    f"max |diff| {diff:.3e} OVER registry.tolerance")
        ms = 1e3 * _median([r["time_s"] for r in mine])
        twin_ms = 1e3 * _median([r["time_s"] for r in tw["results"]])
        gbps = _median([r["reference_gbps"] for r in mine])
        busbw = _median([r["busbw_gbps"] for r in mine])
        share = busbw / p / NVLINK_GBPS
        timing = "chained" if "--timing=chained" in argv else "periter"
        chain_ok, chain = (_chain_note(mc, tw, recs, head)
                           if timing == "chained" else (True, ""))
        print(f"  {head['dtype']} {head['method']} k={head['ranks']} "
              f"n={head['n']} rooted={head['rooted']} {timing}: "
              f"{head['algorithm']} {ms:.5f} ms, {gbps:.4f} GB/s, busbw "
              f"{busbw:.4f} ({busbw / p:.4f} a card, {share:.4f}x NVLink "
              f"{NVLINK_GBPS:.0f}); one card {twin_ms:.5f} ms (ratio "
              f"{ms / twin_ms if twin_ms else float('nan'):.3f}); {bits}"
              f"{'; ' + chain if chain else ''} "
              f"[{','.join(sorted(statuses))}]", flush=True)
        del tw
        if (statuses != {"PASSED"} or algs != {label} or not same
                or not chain_ok):
            bad.append((argv, sorted(statuses), sorted(algs), bits, chain))
    print(f"  twins: {twin_s:.1f} s; rank 0's log of the first row:\n  "
          + run["records"][0][0]["log"].replace("\n", "\n  ").rstrip(),
          flush=True)
    bad += sharded_serving(p)
    bad += ladder_across_cards(p)
    if bad:
        print("  worker logs' tails:\n" + "\n".join(tails), flush=True)
        raise AssertionError(f"[multicard] rows {bad}")
    MULTICARD.update(ran=True, rows=len(rows), why="ran",
                     sharded_rows=2 * len(SHARD_ROWS),
                     ladder_rungs=list(MC_LADDER_KS),
                     ladder_curve_cells=MC_LADDER_QUANT_CELLS
                     + MC_LADDER_RESHARD_CELLS)


# the RED006 count the port's tree gives, pinned at 0 (RED006_PINNED in
# tests/test_torch_lint_clean.py, which holds the two equal)
LINT_RED006_PINNED = 0


def lint_path(driver, counted, kr, registry, config, staging) -> None:
    """[lint]: the port lint over the port and this script, in a process
    of its own, cold and warm; exit 0 and no finding of any rule, RED006
    held at its pin of 0."""
    OUT.mkdir(exist_ok=True)
    cache = (OUT / "lint_cache.json").resolve()
    cache.unlink(missing_ok=True)
    root = Path(__file__).resolve().parent
    passes = []
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "tpu_reductions_torch.lint",
             "tpu_reductions_torch", "chip_smoke.py", "--format=json",
             f"--flow-cache={cache}"], cwd=root, capture_output=True,
            text=True, timeout=600)
        sec = time.perf_counter() - t0
        try:
            rows = json.loads(r.stdout)
        except ValueError:
            raise AssertionError(f"[lint] {label}: exit {r.returncode}, "
                                 f"{r.stderr[-2000:]}")
        rules = sorted({row["rule"] for row in rows})
        print(f"  {label} pass: exit {r.returncode} in {sec:.2f} s, "
              f"{len(rows)} findings {rules}", flush=True)
        passes.append(rows)
        if r.returncode != 0 or rows:
            raise AssertionError(f"[lint] {label}: exit {r.returncode}, "
                                 f"{len(rows)} findings (RED006 pinned at "
                                 f"{LINT_RED006_PINNED}): {rows[:20]}")
    if passes[0] != passes[1]:
        raise AssertionError("[lint] the warm pass differs from the cold")


CLI_PATHS = {"chain": chain_path, "spot": spot_path, "smoke": smoke_path,
             "family": family_path, "firstrow": firstrow_path,
             "warm": warm_path, "shmoo": shmoo_path, "check": check_path,
             "trace": trace_path, "staging": staging_path,
             "collective": collective_path, "round": round_path,
             "quant": quant_path, "rank_scaling": rank_scaling_path,
             "exec": exec_path, "serve": serve_path,
             "fleet": fleet_path, "resilience": resilience_path,
             "experiment": experiment_path,
             "multicard": multicard_path, "lint": lint_path}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tpu_reductions_torch import device
    from tpu_reductions_torch.bench import autotune, driver
    from tpu_reductions_torch.bench import stream as stream_cli
    from tpu_reductions_torch.ops import _cuda, dd_reduce, oracle
    from tpu_reductions_torch.ops import kernel_reduce as kr
    from tpu_reductions_torch import config
    from tpu_reductions_torch.ops import registry
    from tpu_reductions_torch.utils import staging
    from tpu_reductions_torch.utils.rng import host_data

    t_all = time.perf_counter()
    dev = device.resolve("gpu")
    print(f"{device.name(dev)}: torch {torch.__version__} cuda "
          f"{torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    seconds, log = _cuda.build()
    print(f"[build] {seconds:.1f} s\n{log}", flush=True)

    worst = dict.fromkeys(KERNELS, 0.0)
    table = []
    for phase in (k6_k7_vs_plain, k8_k10_vs_plain, k9_vs_plain):
        print(f"[kernels vs plain: {phase.__name__}]", flush=True)
        t0 = time.perf_counter()
        phase(kr, registry, host_data, dev, worst, table)
        print(f"[kernels vs plain: {phase.__name__}] "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if phase is k8_k10_vs_plain:
            # where the bf16 rows just timed read their payload from
            # redlint: disable=RED018 -- main's perf_counter reads print each phase's host seconds against the run's time limit; the probe's numbers are its own CUDA-event times
            passes.l2_probe(kr, registry, host_data, dev)
    print("[kernels vs plain: dd_vs_plain]", flush=True)
    t0 = time.perf_counter()
    dd_vs_plain(dd_reduce, registry, oracle, host_data, dev, worst, table)
    print(f"[kernels vs plain: dd_vs_plain] {time.perf_counter() - t0:.1f} s",
          flush=True)
    print("[profile: k6 and the k7 chain]", flush=True)
    t0 = time.perf_counter()
    profile_phase(kr, dd_reduce, registry, host_data, dev)
    print(f"[profile: k6 and the k7 chain] {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the main path's shape: int32 SUM, n = 2^24 (k9: float32 SUM; dd:
    # float64 SUM)
    shape_dtype = {"k9": "float32", "dd": "float64"}
    main_shape = {r["kernel"]: r for r in table
                  if r["method"] == "SUM" and r["dtype"]
                  == shape_dtype.get(r["kernel"], "int32")}

    counted = wrappers(kr, dd_reduce)
    print("[main path]", flush=True)
    t0 = time.perf_counter()
    routes = []
    paths = {"main_path": drive_main_path(driver, counted, routes)}
    print(f"[main path] {time.perf_counter() - t0:.1f} s, launches "
          f"{paths['main_path']}", flush=True)
    print("[races]", flush=True)
    shutil.rmtree(EVIDENCE_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    for i, launches in enumerate(drive_races(autotune, counted)):
        paths[f"race_{i + 1}"] = launches
    print(f"[races] {time.perf_counter() - t0:.1f} s", flush=True)
    print("[stream]", flush=True)
    t0 = time.perf_counter()
    paths["stream"] = drive_stream(driver, stream_cli, counted, dev)
    print(f"[stream] {time.perf_counter() - t0:.1f} s, launches "
          f"{paths['stream']}", flush=True)
    print("[oracle]", flush=True)
    t0 = time.perf_counter()
    oracle_phase(oracle, host_data, routes)
    print(f"[oracle] {time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in CLI_PATHS.items():
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        for w in counted.values():
            w.launches = 0
        path(driver, counted, kr, registry, config, staging)
        paths[name] = {k: w.launches for k, w in counted.items()}
        print(f"[{name}] {time.perf_counter() - t0:.1f} s, launches "
              f"{paths[name]}", flush=True)
    for name in KERNELS:
        if paths["main_path"][name] == 0:
            raise AssertionError(f"the main path never launched {name}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"[all phases] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {path: p[name]
                                     for path, p in paths.items()},
                "max_abs_err": worst[name], "ms": main_shape[name]["ms"],
                "plain_ms": main_shape[name]["plain_ms"],
                "bound_ms": main_shape[name]["bound_ms"],
                "bound_by": main_shape[name]["bound_by"],
                "library_ms": main_shape[name]["library_ms"]}
               for name in KERNELS]
    for extra in ("reduce_ms", "tree_ms"):    # dd's fused finish
        kernels[KERNELS.index("dd")][extra] = main_shape["dd"][extra]
    # the paths whose zero launches are right: the JAX package computes
    # the collectives with XLA collectives and jnp, not with a kernel
    no_kernel = ("no kernel of the repository: the collectives are "
                 "torch ops over the rank axis, as the JAX package's are "
                 "XLA collectives and jnp")
    print(json.dumps({"kernels": kernels, "notes": {
        "collective": no_kernel, "quant": no_kernel,
        "rank_scaling": no_kernel,
        "exec": "no kernel: the cost oracle reads JSON and touches no "
                "device",
        "lint": "no kernel: a static pass over the port's sources",
        "multicard": dict(MULTICARD, kernel="no kernel of the repository: "
                          "the collectives are torch ops over the rank "
                          "axis and NCCL between the cards; the sharded "
                          "serving part folds each card's shards and "
                          "combines the gathered partials with torch ops, "
                          "as the JAX shard route folds with jnp under "
                          "jax.jit and never reaches pl.pallas_call"),
        "resilience": "its CLIs run in processes of their own, whose "
                      "launches this process does not count (its hang "
                      "and scheduler rows go through k6, its smoke task "
                      "through k8, k9, k10 and dd)",
        "fleet": "no kernel of the repository: the fleet computes with "
                 "torch ops (the shard route's fold, its rank-axis "
                 "combine, the drain's reshard), as the JAX package's "
                 "fleet computes with jnp under jax.jit and XLA "
                 "collectives and never reaches pl.pallas_call; every "
                 "kernel is launched and held against its plain version "
                 "by the phases that do so",
        "serve": "no kernel of the repository: the bucket row-reduce is "
                 "one torch reduction along dim 1, as the JAX package's is "
                 "jnp_reduce under jax.jit"}}))
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return 0


def multicard_main() -> int:
    """`--phase=multicard`: the [multicard] phase alone (on a host of
    several cards), then the cards' names and power limits and the last
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tpu_reductions_torch import config
    from tpu_reductions_torch.ops import registry
    print(f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}: "
          f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    print("[multicard]", flush=True)
    t0 = time.perf_counter()
    # redlint: disable=RED018 -- the phase's host seconds against the run's time limit; its rows carry the device times
    multicard_path(None, None, None, registry, config, None)
    print(f"[multicard] {time.perf_counter() - t0:.1f} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(smi)
    print(json.dumps({"multicard": MULTICARD}))
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return 0


PHASES = {"multicard": multicard_main}


if __name__ == "__main__":
    args = sys.argv[1:]
    if args and (len(args) != 1 or not args[0].startswith("--phase=")
                 or args[0][8:] not in PHASES):
        print(f"usage: chip_smoke.py [--phase={'|'.join(PHASES)}]",
              file=sys.stderr)
        sys.exit(2)
    # redlint: disable=RED017,RED019 -- the card smoke runs under its caller's time limit, which ends the process; arming the watchdog here would end a phase that opens no heartbeat guard, and the CLIs it drives arm their own
    sys.exit(PHASES[args[0][8:]]() if args else main())
