"""Per-pass device times of the port's kernels, for one tree of the port
or for two in turns.

    python tpu_reductions_torch/bench/passes.py [--package-root DIR]
        [--out FILE] [--sweep]

Stages the benchmark payload at the main path's n = 2^24 with the
default tiling (--threads 256, --maxblocks 64), then:

0. first, before any profiler run or other timing, probes where the
   bf16 SUM payload (32 MiB, less than the L2) is read from through
   k6-k10 and torch.sum (`l2_probe`): back-to-back calls, at four
   addresses, against calls after 128 MiB of other data are read;
1. profiles, with torch.profiler, one k6 call and one k7 chain (its
   passes, the copies between them where the tree has any, and the
   finish) at int32 SUM, one k8 call on int32/float32/float64/bf16 SUM
   and bf16 MAX, one k10 call at depths 1 and 4 (int32 SUM), one k9 call
   (float32 SUM), and on float64 SUM through the pair route one
   `dd_call` (the accumulator: pass 1 and the fold of its splits) and
   one reduce of the route, `make_dd_device_reduce`'s core (the
   accumulator and the pair finish), ten times each with a synchronise
   after every call: each CUDA kernel's name, launches and device time,
   and the span of one call from its first kernel's start to its last
   kernel's end (span minus the kernels' time is the device idling
   between launches); beside k8's and dd's, `host_ms`, the host clock
   per call over back-to-back calls ended by one synchronise;
2. times with CUDA events k6, one k7 pass, the k7 chain with its finish
   (`reduce_ms`) and k8 with and without its finish on
   int32/float32/float64 SUM and bf16 SUM/MIN/MAX, each beside one
   PyTorch reduction of the same staged tensor (`library_ms`);
3. times one k7 pass and the k7 chain with its finish at every k7
   geometry of the two races chip_smoke.py drives (the default grid on
   float32 SUM 2^24, the hbm grid on int32 SUM 2^26);
4. times k9 on float32/float64/bfloat16 SUM, k8 and k10 at depths 1, 2,
   4 and 8 on int32 SUM, and dd on float64 SUM (`ms` the accumulator,
   `reduce_ms` the route's core, `tree_ms` the torch halving tree over
   the same accumulator), at n = 2^24, and k8 and k10 at the hbm race's
   tiles and depths on int32 SUM 2^26, each beside `library_ms`.

With --sweep it also times the kernels under geometries their planners
did not pick (k6/k7 clusters and CTA counts; k8's unroll and its split
fold in the pass or in a second launch; k10 stage sizes and splits; k9
runs per warp; dd's splits and pass-2 threads); that needs this tree's
planners.

It calls only the wrapper API that every tree of the port has, so
`--package-root` can import `tpu_reductions_torch` from another checkout
(the parent commit, unpacked into a directory): running the script once
per tree, in turns in one call, compares two trees on one card. The
kernels' own times are chip_smoke.py's; these are for that comparison.
The last line of its output is one JSON object.

No reference analog: the JAX package has no per-pass device profile of its
kernels; each probe here is the port's, on the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

N = 1 << 24       # the main path's payload
# (dtype, method) pairs timed: the main path's int32 SUM first
CASES = (("int32", "SUM"), ("float32", "SUM"), ("float64", "SUM"),
         ("bfloat16", "SUM"), ("bfloat16", "MIN"), ("bfloat16", "MAX"))
# chip_smoke.py's races: the grid, and the payload it reduces with SUM
RACES = (("default", "float32", 1 << 24), ("hbm", "int32", 1 << 26))
PROFILED_CALLS = 10
# k10's depths on the main path, and the hbm race's (TM, depths) of k10
# on int32 SUM 2^26 (bench/autotune.py HBM_GRID)
DEPTHS = (1, 2, 4, 8)
HBM_N = 1 << 26
HBM_STREAM = ((512, (2, 4, 8)), (1024, (2, 4, 8)), (256, (4,)))
MXU_DTYPES = ("float32", "float64", "bfloat16")
# k8's profiled cases: the main path's int32 SUM, every other dtype's SUM,
# and bf16 MAX, whose accumulator is stored as bf16
K8_CASES = (("int32", "SUM"), ("float32", "SUM"), ("float64", "SUM"),
            ("bfloat16", "SUM"), ("bfloat16", "MAX"))
# l2_probe: the bytes k6 reads between two calls to empty the 50 MB L2
L2_FLUSH_BYTES = 128 << 20


def bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits as integers of its width, for a bit-for-bit comparison
    (torch.equal calls -0.0 and 0.0 equal).
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
              torch.float64: torch.int64, torch.int32: torch.int32}
    return t.view(as_int[t.dtype])


def device_ms(fn, calls: int = 20, trials: int = 5) -> float:
    """Device time of one fn() call, in ms: the median over `trials` of
    `calls` back-to-back calls between two CUDA events, queued behind a
    sleep kernel so that host overhead between calls does not count.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
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


def kernel_profile(fn, calls: int = PROFILED_CALLS) -> dict:
    """Run fn() `calls` times under torch.profiler, each call synchronised
    and followed by a 2 ms pause of the host, so that the device events
    of one call are those between two gaps of over 1 ms. Returns the
    device activity of one call, averaged over the calls that recorded
    the most common number of device events (the profiler may drop one):
    per kernel name (in launch order) its launches and device µs; each
    launch's µs in launch order (a kernel run twice in a call, as k6's
    two passes are, shows there as two entries); the µs of all kernels;
    and the median span from the first kernel's start to the last one's
    end. Raises when the profiler saw no device activity.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
            time.sleep(0.002)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    recorded = [[events[0]]]
    for before, e in zip(events, events[1:]):
        if e.time_range.start - before.time_range.end > 1000:
            recorded.append([])
        recorded[-1].append(e)
    per_call = statistics.mode(len(r) for r in recorded)
    kept = [r for r in recorded if len(r) == per_call]
    kernels: dict = {}
    launch_us = [0.0] * per_call
    spans = []
    for call in kept:
        spans.append(call[-1].time_range.end - call[0].time_range.start)
        for j, e in enumerate(call):
            us = e.time_range.end - e.time_range.start
            k = kernels.setdefault(e.name, {"launches": 0, "us": 0.0})
            k["launches"] += 1
            k["us"] += us
            launch_us[j] += us
    rows = [{"name": name, "launches": k["launches"] / len(kept),
             "us": k["us"] / len(kept)} for name, k in kernels.items()]
    return {"kernels": rows,
            "launch_us": [us / len(kept) for us in launch_us],
            "busy_us": sum(r["us"] for r in rows),
            "span_us": statistics.median(spans), "calls": len(kept)}


def profile_k6_k7(kr, registry, host_data, dev) -> dict:
    """kernel_profile of one k6 call and of one k7 chain (passes and
    finish) at int32 SUM n = N, default tiling.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    op = registry.get_op("SUM")
    tm, p, t = kr.choose_tiling(N, 256, 64, "int32")
    x2d = kr.stage_padded(host_data(N, "int32"), tm, p, t, op, dev)
    return {
        "k6": kernel_profile(lambda: kr.single_pass_call(x2d, op)),
        "k7_chain": kernel_profile(lambda: kr.finish(kr._multipass_finish(
            kr.two_pass_call(x2d, op, tm, p, t), op, 256, 64, 1), op)),
    }


def host_ms(fn, calls: int = 50) -> float:
    """Host clock per fn() call, in ms, over `calls` back-to-back calls
    ended by one synchronise: the time a host-bound route takes.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    fn()
    torch.cuda.synchronize()
    # redlint: disable=RED002 -- host_ms is the host clock per call of a host-bound route, printed beside the kernels' CUDA-event times, never as one
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    # redlint: disable=RED002 -- closes the host_ms window of the line above
    return 1e3 * (time.perf_counter() - t0) / calls


def _dd_staged(host_data, dev):
    """(dd_reduce, hi2d, lo2d, tm, core) of float64 SUM at n = N, default
    tiling, through the pair route's own entry point."""
    from tpu_reductions_torch.ops import dd_reduce as dd
    x = host_data(N, "float64")
    stage, core, _ = dd.make_dd_device_reduce("SUM", N, device=dev)
    hi2d, lo2d, _ = stage(x)
    tm = dd.choose_tiling(N)[0]
    return dd, hi2d, lo2d, tm, core


def profile_dd(host_data, dev) -> dict:
    """kernel_profile and host_ms of one dd_call (the accumulator) and of
    one reduce of the f64 pair route (its core: the accumulator and the
    pair finish) at float64 SUM n = N.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    dd, hi2d, lo2d, tm, core = _dd_staged(host_data, dev)
    out = {}
    for what, fn in (("dd_call", lambda: dd.dd_call(hi2d, lo2d, "SUM", tm)),
                     ("dd_route", lambda: core(hi2d, lo2d))):
        out[what] = {**kernel_profile(fn), "host_ms": host_ms(fn)}
    return out


def profile_k8(kr, registry, host_data, dev) -> dict:
    """kernel_profile and host_ms of one k8 call on each of K8_CASES at
    n = N, default tiling.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    out = {}
    for dtype, method in K8_CASES:
        op = registry.get_op(method)
        tm, p, t = kr.choose_tiling(N, 256, 64, dtype)
        x2d = kr.stage_padded(host_data(N, dtype), tm, p, t, op, dev)

        def call():
            return kr.elementwise_call(x2d, op, tm)
        out[f"k8_{dtype}_{method}"] = {**kernel_profile(call),
                                       "host_ms": host_ms(call)}
    return out


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def flusher(kr, registry, dev):
    """A call that reads L2_FLUSH_BYTES of other data through k6, leaving
    L2 with none of a payload read before it and nothing dirty; its
    `launches` are the CUDA launches of one call.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    data = torch.zeros((L2_FLUSH_BYTES // (4 * 128), 128), dtype=torch.int32,
                       device=dev)
    op = registry.get_op("SUM")

    def flush():
        kr.single_pass_call(data, op)
    flush.launches = len(kernel_profile(flush)["launch_us"])
    return flush


def cold_us(call, flush) -> float:
    """Device µs of call()'s launches right after flush()
    (kernel_profile, flush()'s own launches left out).
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    def flushed():
        flush()
        call()
    return sum(kernel_profile(flushed)["launch_us"][flush.launches:])


def l2_probe(kr, registry, host_data, dev) -> dict:
    """Where the bf16 SUM payload at n = N (32 MiB, less than the card's
    50 MB of L2) is read from, through k6, one k7 pass, k8, k9, k10 at
    depth 4 and torch.sum: `warm_ms`, device_ms of back-to-back calls,
    which may find part of the payload in L2 from the call before, on the
    staged payload and on three copies of it (other addresses);
    `cold_us`, one call's kernels right after L2_FLUSH_BYTES of other
    data are read (cold_us). Beside them the SM clock, temperature and
    power.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    op = registry.get_op("SUM")
    tm, p, t = kr.choose_tiling(N, 256, 64, "bfloat16")
    staged = kr.stage_padded(host_data(N, "bfloat16"), tm, p, t, op, dev)
    copies = [staged] + [staged.clone() for _ in range(3)]
    flush = flusher(kr, registry, dev)
    out = {"l2_bytes": torch.cuda.get_device_properties(dev).L2_cache_size,
           "smi_before": _smi("clocks.sm,temperature.gpu,power.draw")}
    calls = {"k6": lambda x: kr.single_pass_call(x, op),
             "k7": lambda x: kr.two_pass_call(x, op, tm, p, t),
             "k8": lambda x: kr.elementwise_call(x, op, tm),
             "k9": lambda x: kr.mxu_call(x, op),
             "k10": lambda x: kr.stream_call(x, op, tm, 4),
             "torch_sum": op.reduce}
    for name, call in calls.items():
        out[name] = {
            "warm_ms": [device_ms(lambda x=x: call(x)) for x in copies],
            "cold_us": cold_us(lambda: call(staged), flush)}
    out["smi_after"] = _smi("clocks.sm,temperature.gpu,power.draw")
    print(f"  l2 probe, bf16 SUM n={N} ({staged.numel() * 2} B, L2 "
          f"{out['l2_bytes']} B), sm MHz, C, W {out['smi_before']} -> "
          f"{out['smi_after']}:", flush=True)
    for name in calls:
        print(f"    {name}: warm " + " ".join(
            f"{ms:.5f}" for ms in out[name]["warm_ms"])
              + f" ms, cold {out[name]['cold_us']:.3f} us", flush=True)
    return out


def profile_k9_k10(kr, registry, host_data, dev) -> dict:
    """kernel_profile of one k10 call at depths 1 and 4 (int32 SUM) and
    one k9 call (float32 SUM), at n = N, default tiling.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    op = registry.get_op("SUM")
    tm, p, t = kr.choose_tiling(N, 256, 64, "int32")
    x2d = kr.stage_padded(host_data(N, "int32"), tm, p, t, op, dev)
    y2d = kr.stage_padded(host_data(N, "float32"),
                          *kr.choose_tiling(N, 256, 64, "float32"), op, dev)
    return {
        "k10_depth1": kernel_profile(lambda: kr.stream_call(x2d, op, tm, 1)),
        "k10_depth4": kernel_profile(lambda: kr.stream_call(x2d, op, tm, 4)),
        "k9_float32": kernel_profile(lambda: kr.mxu_call(y2d, op)),
    }


def print_profile(profiles: dict) -> None:
    """Print one kernel_profile's device activity, launch by launch.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    for what, prof in profiles.items():
        host = (f", host {prof['host_ms']:.5f} ms a call" if "host_ms" in prof
                else "")
        print(f"  profile {what}: span {prof['span_us']:.3f} us, kernels "
              f"{prof['busy_us']:.3f} us, idle between launches "
              f"{prof['span_us'] - prof['busy_us']:.3f} us, "
              f"{len(prof['launch_us'])} launches{host}", flush=True)
        for k in prof["kernels"]:
            print(f"    {k['launches']:g} x {k['us']:9.3f} us  "
                  f"{k['name'][:100]}", flush=True)
        print("    launches in order, us: " + " ".join(
            f"{us:.3f}" for us in prof["launch_us"]), flush=True)


def _print_row(row: dict) -> None:
    print("  " + " ".join(f"{k}={v:.5f}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in row.items()),
          flush=True)


def time_cases(kr, registry, host_data, dev) -> list:
    """CUDA-event times of k6, one k7 pass and the k7 chain with finish,
    beside torch's reduction of the same staged tensor, for CASES at
    n = N.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    rows = []
    for dtype, method in CASES:
        op = registry.get_op(method)
        tm, p, t = kr.choose_tiling(N, 256, 64, dtype)
        x2d = kr.stage_padded(host_data(N, dtype), tm, p, t, op, dev)
        row = {
            "dtype": dtype, "method": method, "n": N,
            "k6_ms": device_ms(lambda: kr.single_pass_call(x2d, op)),
            "k7_pass_ms": device_ms(lambda: kr.two_pass_call(x2d, op, tm, p,
                                                             t)),
            "k7_reduce_ms": device_ms(lambda: kr.finish(kr._multipass_finish(
                kr.two_pass_call(x2d, op, tm, p, t), op, 256, 64, 1), op)),
            "k8_ms": device_ms(lambda: kr.elementwise_call(x2d, op, tm)),
            "k8_reduce_ms": device_ms(lambda: kr.finish(
                kr.elementwise_call(x2d, op, tm), op)),
            "library_ms": device_ms(lambda: op.reduce(x2d)),
        }
        _print_row(row)
        rows.append(row)
    return rows


def time_race_k7(kr, registry, host_data, dev) -> list:
    """CUDA-event times of one k7 pass and of the k7 chain with finish at
    each k7 (--threads, --maxblocks) of the RACES' grids, on the payload
    that race reduces.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    from tpu_reductions_torch.bench.autotune import GRIDS
    from tpu_reductions_torch.config import KERNEL_TWO_PASS
    op = registry.get_op("SUM")
    rows = []
    for grid, dtype, n in RACES:
        x = host_data(n, dtype)
        for kernel, threads, max_blocks, *_ in GRIDS[grid]:
            if kernel != KERNEL_TWO_PASS:
                continue
            tm, p, t = kr.choose_tiling(n, threads, max_blocks, dtype)
            x2d = kr.stage_padded(x, tm, p, t, op, dev)
            row = {
                "grid": grid, "dtype": dtype, "n": n, "threads": threads,
                "max_blocks": max_blocks,
                "k7_pass_ms": device_ms(lambda: kr.two_pass_call(
                    x2d, op, tm, p, t)),
                "k7_reduce_ms": device_ms(lambda: kr.finish(
                    kr._multipass_finish(kr.two_pass_call(x2d, op, tm, p, t),
                                         op, threads, max_blocks, 1), op)),
            }
            print("  race " + " ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()), flush=True)
            rows.append(row)
    return rows


def time_k8_k10_k9_dd(kr, registry, host_data, dev) -> list:
    """CUDA-event times, each beside one PyTorch reduction of the same
    staged tensor: k9 on MXU_DTYPES SUM, k8 and k10 at DEPTHS on int32
    SUM and dd (f64 SUM: the accumulator, the route's reduce and the
    torch tree over the accumulator; its library call sums the native f64
    payload) at n = N, default tiling; then k8 and k10 at HBM_STREAM's
    tiles and depths on int32 SUM n = HBM_N.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    op = registry.get_op("SUM")
    rows = []
    for dtype in MXU_DTYPES:
        x2d = kr.stage_padded(host_data(N, dtype),
                              *kr.choose_tiling(N, 256, 64, dtype), op, dev)
        rows.append({"kernel": "k9", "dtype": dtype, "n": N,
                     "ms": device_ms(lambda: kr.mxu_call(x2d, op)),
                     "library_ms": device_ms(lambda: op.reduce(x2d))})
        _print_row(rows[-1])
    dd, hi2d, lo2d, tm, core = _dd_staged(host_data, dev)
    acc = dd.dd_call(hi2d, lo2d, "SUM", tm)
    # redlint: disable=RED015 -- N = 2^24 float64 (128 MiB), under the stager's one-shot threshold (512 MiB); passes.py also times older trees, which predate staging.stage_flat
    f64 = host_data(N, "float64").to(dev)
    rows.append({"kernel": "dd", "dtype": "float64", "n": N,
                 "ms": device_ms(lambda: dd.dd_call(hi2d, lo2d, "SUM", tm)),
                 "reduce_ms": device_ms(lambda: core(hi2d, lo2d)),
                 "tree_ms": device_ms(lambda: dd.device_finish_pairs(
                     *acc, "SUM")),
                 "library_ms": device_ms(lambda: torch.sum(f64))})
    _print_row(rows[-1])
    cases = [(N, 256, DEPTHS)] + [(HBM_N, tm, depths)
                                  for tm, depths in HBM_STREAM]
    staged = {}
    for n, threads, depths in cases:
        if n not in staged:
            staged[n] = host_data(n, "int32")
        tm, p, t = kr.choose_tiling(n, threads, 64, "int32")
        x2d = kr.stage_padded(staged[n], tm, p, t, op, dev)
        row = {"kernel": "k8/k10", "dtype": "int32", "n": n, "tm": tm,
               "k8_ms": device_ms(lambda: kr.elementwise_call(x2d, op, tm))}
        for d in depths:
            row[f"k10_depth{d}_ms"] = device_ms(
                lambda: kr.stream_call(x2d, op, tm, d))
        row["library_ms"] = device_ms(lambda: op.reduce(x2d))
        _print_row(row)
        rows.append(row)
    return rows


def sweep_plans(kr, registry, host_data, dev) -> list:
    """CUDA-event times of k6 and k7 under other geometries than the
    planners pick, at n = N: k6 (both passes) on int32 and bf16 SUM at
    a quarter to one CTA per SM, in clusters of 1 or 8; one k7 pass over
    P = 64, 32, 16 and 2 equal spans at 1 to 8 CTAs a cluster; and the k7
    chain's two small passes (512 and 16 rows, P = 2 and 1, 256-row
    spans) at 1, 2 and 8. Needs a tree with kernel_reduce.SpanPlan.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    from tpu_reductions_torch.ops import _cuda
    rows_out = []
    sms = kr._sm_count(dev)

    def plan(groups, sub, blocks, cluster, span=None):
        span = span or -(-groups // blocks) * sub
        return kr.SpanPlan(-(-groups * sub // span) if blocks > 1 else blocks,
                           cluster, span, -(-(span // sub) // cluster) * sub)

    def record(what, x2d, p, ms):
        row = {"what": what, "dtype": str(x2d.dtype).split(".")[-1],
               "rows": x2d.shape[0], "blocks": p.blocks,
               "cluster": p.cluster, "ctas": p.blocks * p.cluster, "ms": ms}
        print(f"  sweep {what} {row['dtype']} rows={row['rows']} "
              f"blocks={p.blocks} cluster={p.cluster} "
              f"ctas={row['ctas']} ms={ms:.5f}", flush=True)
        rows_out.append(row)

    op = registry.get_op("SUM")
    for dtype in ("int32", "bfloat16"):
        tm, p, t = kr.choose_tiling(N, 256, 64, dtype)
        x2d = kr.stage_padded(host_data(N, dtype), tm, p, t, op, dev)
        sub = kr.sublanes_for(x2d.dtype)
        groups = x2d.shape[0] // sub
        acc = kr._acc_dtype(x2d.dtype, op)
        out = torch.empty((sub, 128), dtype=acc, device=dev)
        for ctas, cluster in ((sms // 4, 1), (sms // 2, 1), (sms // 2, 8),
                              (3 * sms // 4, 1), (sms, 1), (sms, 8)):
            k6 = plan(groups, sub, ctas // cluster, cluster)
            parts = torch.empty((k6.blocks * sub, 128), dtype=acc,
                                device=dev)
            record("k6", x2d, k6, device_ms(lambda: _cuda.k6_reduce(
                x2d, parts, out, k6, op.name)))
        if dtype != "int32":
            continue
        for p7, cluster in ((64, 1), (64, 2), (32, 1), (32, 2), (16, 1),
                            (16, 4), (2, 1), (2, 8)):
            out7 = torch.empty((p7 * sub, 128), dtype=acc, device=dev)
            k7 = plan(groups, sub, p7, cluster, groups // p7 * sub)
            record("k7", x2d, k7, device_ms(lambda: _cuda.k7_reduce(
                x2d, out7, k7, op.name)))
    for rows, p in ((512, 2), (16, 1)):
        x2d = kr.stage_padded(host_data(rows * 128, "int32"), 8, rows // 8,
                              1, op, dev)
        out = torch.empty((p * 8, 128), dtype=torch.int32, device=dev)
        for cluster in (1, 2, 8):
            k7 = plan(rows // 8, 8, p, cluster, 256)
            record("chain", x2d, k7, device_ms(lambda: _cuda.k7_reduce(
                x2d, out, k7, op.name)))
    return rows_out


def sweep_k9_k10(kr, registry, host_data, dev) -> list:
    """CUDA-event times of k10 and k9 under other geometries than
    plan_k10 and plan_k9 pick, at n = N: k10 (both passes, int32 SUM, TM
    256) at depths 1 and 4 with stages of 1, 2 and 4 chunks, and with
    half and twice the planned splits (other splits add in another
    order: timed only); k9 (both passes, float32/float64/bfloat16 SUM)
    with runs of half and twice the planned run. Needs a tree with
    kernel_reduce.plan_k10 and plan_k9.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    from tpu_reductions_torch.ops import _cuda
    op = registry.get_op("SUM")
    sms = kr._sm_count(dev)
    rows_out = []

    def record(what, geometry, ms):
        rows_out.append({"what": what, **geometry, "ms": ms})
        print(f"  sweep {what} " + " ".join(f"{k}={v}" for k, v in
                                            geometry.items())
              + f" ms={ms:.5f}", flush=True)

    tm, p, t = kr.choose_tiling(N, 256, 64, "int32")
    x2d = kr.stage_padded(host_data(N, "int32"), tm, p, t, op, dev)
    tiles = x2d.shape[0] // tm
    out = torch.empty((tm, 128), dtype=torch.int32, device=dev)
    for depth in (1, 4):
        plan = kr.plan_k10(tiles, tm, 8, 4, depth, sms)
        variants = ([(plan.splits, c) for c in (1, 2, 4)]
                    + [(plan.splits // 2, plan.chunks),
                       (plan.splits * 2, plan.chunks)])
        for splits, chunks in variants:
            k10 = kr.StreamPlan(splits, depth, chunks)
            parts = torch.empty((splits * tm, 128), dtype=torch.int32,
                                device=dev)
            record("k10", {"depth": depth, "splits": splits,
                           "chunks": chunks, "planned": k10 == plan},
                   device_ms(lambda: _cuda.k10_reduce(x2d, parts, out, tm,
                                                      k10, op.name)))
    for dtype in MXU_DTYPES:
        y2d = kr.stage_padded(host_data(N, dtype),
                              *kr.choose_tiling(N, 256, 64, dtype), op, dev)
        slabs = y2d.shape[0] // kr.MXU_SLAB_ROWS[y2d.dtype]
        plan = kr.plan_k9(slabs, sms)
        out9 = torch.empty((8, 128), dtype=kr.accum_dtype(y2d.dtype),
                           device=dev)
        for run in sorted({max(1, plan.run // 2), plan.run, 2 * plan.run}):
            k9 = kr.MxuPlan(run, -(-slabs // (run * kr.MXU_WARPS)))
            parts = torch.empty((k9.blocks, 128), dtype=out9.dtype,
                                device=dev)
            record("k9", {"dtype": dtype, "run": run, "blocks": k9.blocks,
                          "planned": k9 == plan},
                   device_ms(lambda: _cuda.k9_reduce(y2d, parts, out9, k9)))
    return rows_out


# k8's sweep: the TMs whose plans give from 2 x 132 splits down to 8 (16
# for bf16) at n = N on 132 SMs (the first is the dtype's sublane count),
# for the dtypes swept across TMs
K8_SWEEP_TMS = (None, 32, 64, 128, 256)
K8_SWEEP_DTYPES = ("int32", "float64", "bfloat16")


def sweep_k8(kr, registry, host_data, dev) -> list:
    """Times of k8 at n = N under other geometries than plan_k8 picks,
    each both warm (device_ms) and cold (cold_us: one call's kernels
    after L2_FLUSH_BYTES of other data are read): for K8_SWEEP_DTYPES'
    SUM at each of K8_SWEEP_TMS, the split fold in the pass (`fused`)
    and in a second launch, at the default unroll; on int32, float32,
    float64 and bfloat16 SUM at TM 256, every unroll of K8_UNROLLS. The
    splits are plan_splits' (the same order of adds, so the same bits).
    Needs a tree with kernel_reduce.plan_k8.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    from tpu_reductions_torch.ops import _cuda
    op = registry.get_op("SUM")
    sms = kr._sm_count(dev)
    flush = flusher(kr, registry, dev)
    rows_out = []

    def record(x2d, tm, plan):
        tiles = x2d.shape[0] // tm
        out, parts = kr._period_buffers(x2d, op, tm, plan.splits)

        def call():
            _cuda.k8_reduce(x2d, parts, out, kr._tickets(dev), tm, plan,
                            op.name)
        row = {"what": "k8", "dtype": str(x2d.dtype).split(".")[-1],
               "tm": tm, "splits": plan.splits, "unroll": plan.unroll,
               "fused": plan.fused,
               "planned": plan == kr.plan_k8(tiles, tm, kr.sublanes_for(
                   x2d.dtype), sms),
               "ms": device_ms(call), "cold_us": cold_us(call, flush)}
        print("  sweep " + " ".join(f"{k}={v:.5f}" if isinstance(v, float)
                                    else f"{k}={v}" for k, v in row.items()),
              flush=True)
        rows_out.append(row)

    for dtype in ("int32", "float32", "float64", "bfloat16"):
        tm, p, t = kr.choose_tiling(N, 256, 64, dtype)
        x2d = kr.stage_padded(host_data(N, dtype), tm, p, t, op, dev)
        sub = kr.sublanes_for(x2d.dtype)
        for tm in (K8_SWEEP_TMS if dtype in K8_SWEEP_DTYPES else (256,)):
            tm = tm or sub
            plan = kr.plan_k8(x2d.shape[0] // tm, tm, sub, sms)
            for unroll in kr.K8_UNROLLS:
                for fused in ((True, False) if plan.splits > 1 else (True,)):
                    if unroll != plan.unroll and (tm != 256
                                                  or fused != plan.fused):
                        continue
                    record(x2d, tm, kr.PeriodPlan(plan.splits, unroll,
                                                  fused))
    return rows_out


def sweep_dd(host_data, dev) -> list:
    """CUDA-event times of dd on float64 SUM at n = N, default tiling,
    under other geometries than plan_dd picks: the accumulator alone and
    with the scalar pair, at 1 to 8 splits (other splits add in another
    order: timed only) and 2048 to 8192 pass-2 threads, each with its
    launches' device times (kernel_profile). Needs a tree with
    dd_reduce.plan_dd.
    No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    from tpu_reductions_torch.ops import _cuda
    dd, hi2d, lo2d, tm, _ = _dd_staged(host_data, dev)
    planned = dd.plan_dd(hi2d.shape[0] // tm, tm, dd._sm_count(dev))
    rows_out = []
    for splits in sorted({1, 2, 4, 8, planned.splits}):
        for residues in (2048, 4096, 8192):
            plan = dd.DdPlan(splits, residues)
            out = torch.empty(dd._out_words(tm, plan), dtype=hi2d.dtype,
                              device=dev)
            row = {"what": "dd", "splits": splits, "residues": residues,
                   "planned": plan == planned}
            for form, scalar in (("scalar", True), ("acc", False)):
                def call():
                    _cuda.dd_reduce(hi2d, lo2d, out, dd._tickets(dev), tm,
                                    plan, "SUM", scalar)
                row[f"{form}_ms"] = device_ms(call)
                row[f"{form}_launch_us"] = [
                    round(us, 3) for us in kernel_profile(call)["launch_us"]]
            print("  sweep " + " ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()), flush=True)
            rows_out.append(row)
    return rows_out


def main(argv=None) -> int:
    """CLI: the probes of the module docstring for one tree, or for two in
    turns. No reference analog: a card-only probe of the port's kernels
    (bench/passes.py)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=str(Path(__file__)
                                                  .resolve().parents[2]),
                    help="directory holding the tpu_reductions_torch to "
                         "time (default: this checkout)")
    ap.add_argument("--out", default="", help="also write the JSON here")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the kernels under other geometries")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("passes: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    from tpu_reductions_torch import device
    from tpu_reductions_torch.ops import _cuda
    from tpu_reductions_torch.ops import kernel_reduce as kr
    from tpu_reductions_torch.ops import registry
    from tpu_reductions_torch.utils.rng import host_data

    dev = device.resolve("gpu")
    # the watchdog, armed before the first device call
    from tpu_reductions_torch.exec.core import maybe_arm
    maybe_arm("gpu")
    seconds, log = _cuda.build()
    smi = _smi("name,power.limit")
    print(f"{kr.__file__} on {smi} (build {seconds:.1f} s)", flush=True)
    for part in log.split("== nvcc "):     # the register reports
        if part.startswith(("reduce.cu", "accumulate.cu", "mxu.cu",
                            "pair.cu")):
            print(part, flush=True)
    # first, before any profiler run and any other timing
    probe = l2_probe(kr, registry, host_data, dev)
    profiles = profile_k6_k7(kr, registry, host_data, dev)
    profiles.update(profile_k8(kr, registry, host_data, dev))
    profiles.update(profile_k9_k10(kr, registry, host_data, dev))
    profiles.update(profile_dd(host_data, dev))
    print_profile(profiles)
    result = {"package": kr.__file__, "card": smi, "l2_probe": probe,
              "profile": profiles,
              "times": time_cases(kr, registry, host_data, dev),
              "races": time_race_k7(kr, registry, host_data, dev),
              "k8_k10_k9_dd": time_k8_k10_k9_dd(kr, registry, host_data,
                                                dev)}
    if args.sweep:
        result["sweep"] = (sweep_plans(kr, registry, host_data, dev)
                           + sweep_k8(kr, registry, host_data, dev)
                           + sweep_k9_k10(kr, registry, host_data, dev)
                           + sweep_dd(host_data, dev))
    text = json.dumps(result)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    # redlint: disable=RED019 -- the per-kernel profiler: it launches the bare kernels under torch.profiler and CUDA events, where a LaunchPlan's guard would be in the trace it reads; the watchdog is armed in main
    sys.exit(main())
