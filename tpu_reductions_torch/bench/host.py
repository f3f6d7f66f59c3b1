"""Host times of a large row's set-up and verification, on a machine with
one NVIDIA GPU.

    python -m tpu_reductions_torch.bench.host [--out FILE]

1. Staging of int32 payloads at n = 2^24, 2^26, 2^28 and 2^30 (64 MiB
   to 4 GiB), the CLI's default tiling: the one-shot copy of
   `kernel_reduce.stage_padded` (one pageable host-to-device copy into
   the identity-filled tensor) against `utils/staging.device_put_chunked`
   with 1 and 2 pinned slots and chunks of 16, 64 and 256 MiB. Each
   variant runs TRIALS times, the variants in turns, each timed on the
   host clock to a synchronise; every staged tensor must equal the
   one-shot one bit for bit.
2. The payload fill and the SUM oracle at n = 2^24 and 2^30, int32 and
   float32, on the native route (csrc/oracle.cpp) and on the numpy route.

All of it is host work bound by the machine the card sits in, so its
numbers compare only within one run. The last line of the output is one
JSON object.

No reference analog: the JAX package times no host staging or oracle on its
own; this probe is the port's, for the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

STAGE_SIZES = (1 << 24, 1 << 26, 1 << 28, 1 << 30)
CHUNK_MIB = (16, 64, 256)
SLOTS = (1, 2)
TRIALS = 3
ORACLE_SIZES = (1 << 24, 1 << 30)
ORACLE_DTYPES = ("int32", "float32")


def _seconds(fn, dev=None):
    """(fn's result, host seconds to its end, the card's work included)."""
    # redlint: disable=RED002 -- bench/host.py measures host seconds (staging copies, fill, oracle) by design: the copy's end is the card's
    t0 = time.perf_counter()
    out = fn()
    if dev is not None:
        torch.cuda.synchronize(dev)
    # redlint: disable=RED002 -- closes the host-seconds window of the line above
    return out, time.perf_counter() - t0


def time_staging(dev, n: int) -> list:
    """Section 1 at n: one row per variant, with its median seconds and
    GB/s.
    No reference analog (the module docstring)."""
    from tpu_reductions_torch.ops import kernel_reduce as kr
    from tpu_reductions_torch.ops.registry import get_op
    from tpu_reductions_torch.utils.staging import device_put_chunked

    flat = torch.arange(n, dtype=torch.int32)
    op = get_op("SUM")
    tm, p, t = kr.choose_tiling(n, 256, 64)
    rows, lanes = kr.padded_2d_shape(n, tm, p, t)
    nbytes = n * flat.element_size()

    def one_shot():
        os.environ["TPU_REDUCTIONS_STAGE_THRESHOLD_BYTES"] = str(2 * nbytes)
        try:
            return kr.stage_padded(flat, tm, p, t, op, dev)
        finally:
            del os.environ["TPU_REDUCTIONS_STAGE_THRESHOLD_BYTES"]

    variants = {"one-shot": one_shot}
    for slots in SLOTS:
        for mib in CHUNK_MIB:
            variants[f"chunked slots={slots} chunk={mib} MiB"] = (
                lambda s=slots, m=mib: device_put_chunked(
                    flat, rows, lanes, 0, dev, chunk_bytes=m << 20,
                    slots=s))
    want, _ = _seconds(one_shot, dev)
    times = {name: [] for name in variants}
    for _ in range(TRIALS):
        for name, fn in variants.items():
            got, seconds = _seconds(fn, dev)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: staged tensor differs from "
                                     "the one-shot stage")
            del got
            times[name].append(seconds)
    rows_out = []
    for name, ts in times.items():
        med = statistics.median(ts)
        rows_out.append({"what": name, "n": n, "bytes": nbytes, "s": med,
                         "gbps": nbytes / med / 1e9, "trials": ts})
        print(f"  n={n} stage {name}: {med:.4f} s, "
              f"{nbytes / med / 1e9:.4f} GB/s "
              f"(trials {', '.join(f'{x:.4f}' for x in ts)})", flush=True)
    return rows_out


def time_oracle() -> list:
    """Section 2: fill and SUM oracle on both routes.
    No reference analog (the module docstring)."""
    from tpu_reductions_torch.ops import oracle
    from tpu_reductions_torch.utils.rng import host_data

    if not oracle.native_available():
        raise AssertionError("the native oracle did not build on this host")
    rows_out = []
    real = oracle._load
    for n in ORACLE_SIZES:
        for dtype in ORACLE_DTYPES:
            native, fill_s = _seconds(lambda: oracle.native_fill(n, dtype))
            value, sum_s = _seconds(lambda: oracle.host_reduce(native, "SUM"))
            del native
            numpy_x, numpy_fill_s = _seconds(lambda: host_data(n, dtype))
            oracle._load = lambda: None      # the numpy route
            try:
                numpy_value, numpy_sum_s = _seconds(
                    lambda: oracle.host_reduce(numpy_x, "SUM"))
            finally:
                oracle._load = real
            del numpy_x
            row = {"dtype": dtype, "n": n, "fill_native_s": fill_s,
                   "fill_numpy_s": numpy_fill_s, "sum_native_s": sum_s,
                   "sum_numpy_s": numpy_sum_s, "sum_native": repr(value),
                   "sum_numpy": repr(numpy_value)}
            rows_out.append(row)
            print(f"  {dtype} n={n}: fill native {fill_s:.4f} s, numpy "
                  f"{numpy_fill_s:.4f} s; SUM oracle native {sum_s:.4f} s "
                  f"({value!r}), numpy {numpy_sum_s:.4f} s "
                  f"({numpy_value!r})", flush=True)
    return rows_out


def main(argv=None) -> int:
    """CLI: sections 1 and 2 of the module docstring, into --out.
    No reference analog."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host: no CUDA device is available", file=sys.stderr)
        return 1
    from tpu_reductions_torch import device
    from tpu_reductions_torch.exec.core import maybe_arm

    dev = device.resolve("gpu")
    maybe_arm("gpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"{smi}; {os.cpu_count()} host CPUs, "
          f"{torch.get_num_threads()} torch threads", flush=True)
    print("[staging]", flush=True)
    staging = [row for n in STAGE_SIZES for row in time_staging(dev, n)]
    print("[oracle]", flush=True)
    result = {"card": smi, "staging": staging, "oracle": time_oracle()}
    text = json.dumps(result)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    # redlint: disable=RED019 -- a host-clock instrument of staging copies and the oracle: its copies are the measurement and run unplanned; the watchdog is armed in main and the run is bounded by its caller's time limit
    sys.exit(main())
