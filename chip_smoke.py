#!/usr/bin/env python3
"""Chip smoke test of tpu_reductions_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

1. Builds the hand-written kernels (tpu_reductions_torch/csrc/*.cu) with
   nvcc and prints the build time and the register report.
2. Holds k6 and k7 against their plain PyTorch versions on the card, for
   SUM/MIN/MAX x int32/float32/float64/bfloat16 at n = 2^24 and at a
   ragged n = 2^24 + 37, and times each kernel, its plain version and one
   PyTorch reduction of the same staged tensor with CUDA events.
3. Drives the port's main path, its CLI `main()`, for the benchmark rows
   below, each to a verified PASSED row, and checks through the wrappers'
   launch counters that the rows went through the kernels.
4. Prints the card's name and power limit, a `kernels` JSON line, and as
   the last line `{"ok": true, "device": {...}}`.

Any disagreement, failed row or missing launch raises, and the script
exits non-zero without the last line; so it does when no CUDA device is
available or the package is missing.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

import torch

N = 1 << 24
SIZES = (N, N + 37)
DTYPES = ("int32", "float32", "float64", "bfloat16")
METHODS = ("SUM", "MIN", "MAX")
# H100 SXM published peaks at 700 W: the device-memory rate, and the
# float32 rate outside the tensor cores (the one CUDA-core rate NVIDIA's
# data sheet gives; a reduction does one combine per element on them)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
SOURCE = "tpu_reductions_torch/csrc/reduce.cu"
REPLACES = {"k6": "tpu_reductions/ops/pallas_reduce.py:390",
            "k7": "tpu_reductions/ops/pallas_reduce.py:404"}

# The main path: the benchmark CLI rows, and the kernel each must launch.
MAIN_ROWS = (
    [([f"--method={m}", f"--type={t}", "--kernel=6"], "k6")
     for m in METHODS for t in ("int", "float", "double")]
    + [([f"--method={m}", "--type=int", "--kernel=7"], "k7") for m in METHODS]
    + [(["--method=SUM", "--type=int", "--kernel=7", "--cpufinal"], "k7"),
       (["--method=SUM", "--type=int", "--timing=bulk"], "k6"),
       (["--method=SUM", "--type=int", "--timing=chained"], "k6"),
       (["--method=SUM", "--type=float", f"--n={1 << 28}",
         "--timing=chained"], "k6"),
       (["--method=SUM", "--type=int", "--backend=torch"], None)])


def device_ms(fn, calls: int = 20, trials: int = 5) -> float:
    """Device time of one fn() call, in ms: the median over `trials` of
    `calls` back-to-back calls between two CUDA events. A sleep kernel
    queued first lets the host enqueue every call before the first event
    fires, so host overhead between calls does not count."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def bound(x2d, out) -> dict:
    """The least time the card could take to fold x2d into out: the larger
    of reading x2d and writing out once at the memory rate, and one
    combine per element of x2d at the core rate."""
    nbytes = x2d.numel() * x2d.element_size() + out.numel() * out.element_size()
    by = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
          "operations": 1e3 * x2d.numel() / CORE_OPS_PER_S}
    bound_by = max(by, key=by.get)
    return {"bound_ms": by[bound_by], "bound_by": bound_by}


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


def kernels_vs_plain(kr, registry, host_data, dev):
    """Phase 2. Returns {kernel: stats} at the main path's shape (int32
    SUM, n = 2^24) plus the per-pair table."""
    table = []
    worst = {"k6": 0.0, "k7": 0.0}
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
                worst["k6"] = max(worst["k6"], check_pair(
                    kr, registry, "k6", k6, kr.single_pass_plain(x2d, op),
                    method, dtype, n, x2d.shape[0] // sub))
                worst["k7"] = max(worst["k7"], check_pair(
                    kr, registry, "k7", k7,
                    kr.two_pass_plain(x2d, op, tm, p, t),
                    method, dtype, n, t * tm // sub))
                if n != N:
                    continue
                for name, out, call, plain, reduce in (
                        ("k6", k6, lambda: kr.single_pass_call(x2d, op),
                         lambda: kr.single_pass_plain(x2d, op),
                         lambda: kr.finish(kr.single_pass_call(x2d, op), op)),
                        ("k7", k7, lambda: kr.two_pass_call(x2d, op, tm, p, t),
                         lambda: kr.two_pass_plain(x2d, op, tm, p, t),
                         lambda: kr.finish(kr._multipass_finish(
                             kr.two_pass_call(x2d, op, tm, p, t), op, 256,
                             64, 1), op))):
                    # reduce_ms: the whole device reduce of the main path
                    # (k7: every pass of the chain), finish included
                    row = {"kernel": name, "method": method, "dtype": dtype,
                           "n": n, "rows": x2d.shape[0],
                           "ms": device_ms(call),
                           "plain_ms": device_ms(plain),
                           "library_ms": device_ms(lambda: op.reduce(x2d)),
                           "reduce_ms": device_ms(reduce),
                           **bound(x2d, out)}
                    table.append(row)
                    print(f"  {name} {method:3s} {dtype:8s} n={n} "
                          f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f}"
                          f" library_ms={row['library_ms']:.5f} "
                          f"reduce_ms={row['reduce_ms']:.5f} "
                          f"bound_ms={row['bound_ms']:.5f} "
                          f"({row['bound_by']})", flush=True)
    main_shape = {r["kernel"]: r for r in table
                  if r["method"] == "SUM" and r["dtype"] == "int32"}
    return main_shape, worst, table


def drive_main_path(driver, kr):
    """Phase 3: every MAIN_ROWS row through the CLI to PASSED. Returns the
    launches of each kernel over the whole main path."""
    kr.single_pass_call.launches = 0
    kr.two_pass_call.launches = 0
    for argv, kernel in MAIN_ROWS:
        argv = argv + ["--logfile="]
        before = (kr.single_pass_call.launches, kr.two_pass_call.launches)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = driver.main(argv)
        text = out.getvalue()
        print(text, end="")
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
        after = (kr.single_pass_call.launches, kr.two_pass_call.launches)
        if rc != 0 or "Reduction, Throughput = " not in text \
                or "&&&& tpu_reductions_torch PASSED" not in text:
            raise AssertionError(f"main path row {argv} did not pass "
                                 f"(exit {rc})")
        rose = {"k6": after[0] > before[0], "k7": after[1] > before[1]}
        if kernel is not None and not rose[kernel]:
            raise AssertionError(f"row {argv} never launched {kernel}")
        if kernel is None and any(rose.values()):
            raise AssertionError(f"comparator row {argv} launched a kernel")
    return {"k6": kr.single_pass_call.launches,
            "k7": kr.two_pass_call.launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tpu_reductions_torch import device
    from tpu_reductions_torch.bench import driver
    from tpu_reductions_torch.ops import _cuda
    from tpu_reductions_torch.ops import kernel_reduce as kr
    from tpu_reductions_torch.ops import registry
    from tpu_reductions_torch.utils.rng import host_data

    dev = device.resolve("gpu")
    print(f"{device.name(dev)}: torch {torch.__version__} cuda "
          f"{torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    seconds, log = _cuda.build()
    print(f"[build] {seconds:.1f} s\n{log}", flush=True)

    print("[kernels vs plain]", flush=True)
    main_shape, worst, _table = kernels_vs_plain(kr, registry, host_data, dev)

    print("[main path]", flush=True)
    t0 = time.perf_counter()
    launches = drive_main_path(driver, kr)
    print(f"[main path] {time.perf_counter() - t0:.1f} s, launches {launches}",
          flush=True)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(smi)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": worst[name], "ms": main_shape[name]["ms"],
                "plain_ms": main_shape[name]["plain_ms"],
                "bound_ms": main_shape[name]["bound_ms"],
                "bound_by": main_shape[name]["bound_by"],
                "library_ms": main_shape[name]["library_ms"]}
               for name in ("k6", "k7")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
