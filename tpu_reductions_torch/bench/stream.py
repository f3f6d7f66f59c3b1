"""The streaming-pipeline probe: sustained GB/s and chunks/s, with resume
and a serial stage-then-reduce comparator.

The counterpart of tpu_reductions/bench/stream.py:1. It measures
ops/stream.py's pipeline: bounded chunks copied to the card while the
previous chunk is folded, the running partial fetched every `sync_every`
chunks. So it reports a sustained rate over the wall clock to the final
materialization, not a per-launch one. A stream's rate is bound by the
host link (the pinned host-to-device copy), not by device memory.

Resume: every fetch of the partial persists a checkpoint row (the partial
and the incremental oracle's state, bench/resume.Checkpoint). A run
against an incomplete artifact restores the latest one and folds only the
remaining chunks; since the folds cross the same chunk boundaries, its
value equals an uninterrupted run's, bit for bit.

`stream_markdown` formats finished probe artifacts as report.md's table.

`--serial-baseline` stages every chunk first, each copy forced to
completion with a device synchronize, then folds them all, then fetches:
the serial shape on the same chunks and folds. It reports
overlap_efficiency = serial wall / streamed wall.

    python -m tpu_reductions_torch.bench.stream --method=SUM --type=int \\
        --n=268435456 [--chunk-bytes=16777216 --sync-every=8] \\
        [--serial-baseline] [--platform=cpu] --out=stream_probe.json
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.bench.resume import Checkpoint
from tpu_reductions_torch.config import DTYPE_ALIASES, METHODS, PLATFORMS
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.ops.oracle import IncrementalOracle, payload
from tpu_reductions_torch.ops.oracle import verify as verify_fn
from tpu_reductions_torch.ops.stream import (StreamReducer, dtype_name,
                                             iter_chunks, partial_from_jsonable,
                                             partial_to_jsonable, plan_chunks,
                                             run_stream)
from tpu_reductions_torch.utils import heartbeat


def run_serial_baseline(flat: torch.Tensor, method: str, *,
                        chunk_bytes: Optional[int] = None,
                        device: torch.device) -> dict:
    """The comparator: every chunk staged to completion (synchronized),
    then every fold, then the materialization; one device buffer per
    chunk. The overlap is all that differs from run_stream.
    The counterpart of tpu_reductions/bench/stream.py:64."""
    flat = flat.reshape(-1)
    dtype = dtype_name(flat.dtype)
    chunks = plan_chunks(flat.numel(), dtype, chunk_bytes).num_chunks
    r = StreamReducer(method, dtype, flat.numel(), chunk_bytes=chunk_bytes,
                      device=device, slots=chunks)
    # redlint: disable=RED002 -- the serial baseline's wall seconds are the instrument: the overlap verdict compares them with run_stream's wall seconds
    t0 = time.monotonic()
    r.restore(None)
    staged = []
    # redlint: disable=RED025 -- the serial non-overlapped baseline instrument: its guard edges bracket exactly the measured stage+synchronize sequence the overlap comparison is against, not a launch plan
    with heartbeat.guard("stream"):
        for i in range(chunks):
            staged.append(r.stage(flat, i))
            device_mod.synchronize(device)    # strictly serial copies
            heartbeat.tick()
        for s in staged:
            r.fold(s)
        partial = r.partial()
    # redlint: disable=RED002 -- closes the serial baseline's window of the line above
    wall = time.monotonic() - t0
    nbytes = flat.numel() * flat.element_size()
    row = {"wall_s": wall,
           "gbps": (nbytes / wall) / 1e9 if wall > 0 else None,
           "value": float(np.asarray(r.finish(partial), np.float64))}
    ledger.emit("stream.serial", wall_s=round(wall, 6), chunks=chunks,
                gbps=round(row["gbps"], 4) if row["gbps"] else None)
    return row


def run_stream_benchmark(method: str, dtype: str, n: int, *,
                         seed: int = 0,
                         chunk_bytes: Optional[int] = None,
                         sync_every: int = 8,
                         verify: bool = True,
                         serial_baseline: bool = False,
                         out: Optional[str] = None,
                         platform: str = "gpu",
                         device_index: Optional[int] = None,
                         log=print) -> dict:
    """One streamed reduction end to end: payload, resume lookup, the
    pipeline with checkpoints, the oracle's verdict and the optional
    serial comparator. Returns the final row. Shared by this module's CLI
    and the driver's --stream.
    The counterpart of tpu_reductions/bench/stream.py:107."""
    dtype = DTYPE_ALIASES[dtype]
    device = device_mod.resolve(platform, device_index)
    reducer = StreamReducer(method, dtype, n, chunk_bytes=chunk_bytes,
                            device=device)
    plan = reducer.plan
    sync_every = max(1, int(sync_every))
    # a checkpointed partial is valid only under the same plan and oracle
    meta = {"mode": "stream", "method": reducer.method, "dtype": dtype,
            "n": n, "seed": seed, "chunk_elems": plan.chunk_elems,
            "chunk_bytes": plan.chunk_bytes, "sync_every": sync_every,
            "verify": bool(verify)}
    ck = Checkpoint(out, meta,
                    key_fn=lambda r: ("final" if r.get("final")
                                      else "sync", r.get("chunks_done")))

    start_chunk = 0
    init_partial = None
    oracle = IncrementalOracle(reducer.method, dtype) if verify else None
    resumed_row = None
    for done in sorted({plan.num_chunks,
                        *range(sync_every, plan.num_chunks, sync_every)},
                       reverse=True):
        resumed_row = ck.resume(("sync", done),
                                reusable=lambda r: "partial" in r)
        if resumed_row is not None:
            break
    if resumed_row is not None:
        start_chunk = int(resumed_row["chunks_done"])
        init_partial = partial_from_jsonable(resumed_row["partial"])
        if verify and resumed_row.get("oracle"):
            oracle = IncrementalOracle.from_state(resumed_row["oracle"])
        ck.add(resumed_row)      # carry the checkpoint forward
        log(f"stream: resumed from checkpoint at chunk {start_chunk}/"
            f"{plan.num_chunks} (interrupted run; partial reused, "
            "chunks before it never re-staged)")

    # the native filler's payload where it is in use, as the JAX CLI's
    x = payload(n, dtype, rank=0, seed=seed)

    oracle_s = [0.0]             # host verification time, carved out of
    last_done = [start_chunk]    # the pipeline's wall clock

    def on_sync(done, partial):
        t0 = time.monotonic()
        if oracle is not None:
            for c in iter_chunks(x, plan, last_done[0]):
                oracle.update(c)
                last_done[0] += 1
                if last_done[0] >= done:
                    break
        row = {"chunks_done": done, "partial": partial_to_jsonable(partial)}
        if oracle is not None:
            row["oracle"] = oracle.state()
        ck.add(row)
        oracle_s[0] += time.monotonic() - t0

    res = run_stream(x, reducer.method, sync_every=sync_every,
                     start_chunk=start_chunk, init_partial=init_partial,
                     on_sync=on_sync, reducer=reducer)
    # the pipeline's rate leaves out the oracle and checkpoint time spent
    # in the sync callbacks; the serial comparator has none
    stream_wall_s = max(res.wall_s - oracle_s[0], 1e-9)
    gbps = (res.nbytes / stream_wall_s) / 1e9
    chunks_per_s = (res.chunks_done - res.resumed_from) / stream_wall_s

    status = "PASSED"
    oracle_val = None
    diff = None
    if oracle is not None:
        ok, diff = verify_fn(res.value, oracle.value(), reducer.method,
                             dtype, n)
        oracle_val = float(np.asarray(oracle.value(), np.float64))
        status = "PASSED" if ok else "FAILED"

    final = {"final": True, "chunks_done": res.chunks_done,
             "num_chunks": plan.num_chunks,
             "chunk_elems": plan.chunk_elems,
             "resumed_from": res.resumed_from,
             "result": float(np.asarray(res.value, np.float64)),
             "oracle": oracle_val, "diff": diff, "status": status,
             "gbps_sustained": round(gbps, 4),
             "chunks_per_s": round(chunks_per_s, 4),
             "stream_wall_s": round(stream_wall_s, 6),
             "oracle_wall_s": round(oracle_s[0], 6),
             "max_resident_chunks": reducer.slots,
             "device": device_mod.name(device)}

    if serial_baseline and start_chunk == 0:
        del reducer, res        # free the pipeline's buffers first
        serial = run_serial_baseline(x, method, chunk_bytes=chunk_bytes,
                                     device=device)
        eff = serial["wall_s"] / stream_wall_s
        final["serial_wall_s"] = round(serial["wall_s"], 6)
        final["serial_gbps"] = round(serial["gbps"], 4) \
            if serial["gbps"] else None
        final["overlap_efficiency"] = round(eff, 4)
        ledger.emit("stream.overlap",
                    stream_wall_s=final["stream_wall_s"],
                    serial_wall_s=final["serial_wall_s"],
                    efficiency=final["overlap_efficiency"])
    elif serial_baseline:
        log("stream: serial baseline skipped (resumed run: the streamed "
            "wall clock covers only the remaining chunks and would not be "
            "comparable)")

    ck.add(final)
    ck.finalize()
    return final


def stream_markdown(probes: dict) -> str:
    """The streaming-pipeline table of report.md: pure formatting over
    probe artifacts, {label: parsed artifact}, one row from each one's
    final row (bench/regen.py folds stream_probe.json and
    stream_hazard.json from the experiment dir).
    The counterpart of tpu_reductions/bench/stream.py:245."""
    lines = ["## streaming pipeline (committed probes)", "",
             "| probe | method/dtype | n | chunks | GB/s sustained "
             "| chunks/s | overlap | status |",
             "|---|---|---|---|---|---|---|---|"]
    any_row = False
    for label in sorted(probes):
        data = probes[label]
        if not isinstance(data, dict):
            continue
        final = next((r for r in reversed(data.get("rows", []))
                      if isinstance(r, dict) and r.get("final")), None)
        if final is None:
            continue
        any_row = True
        eff = final.get("overlap_efficiency")
        lines.append(
            f"| {label} | {data.get('method', '?')}/"
            f"{data.get('dtype', '?')} | {data.get('n', '?')} "
            f"| {final.get('num_chunks', '?')} "
            f"| {final.get('gbps_sustained', '-')} "
            f"| {final.get('chunks_per_s', '-')} "
            f"| {f'x{eff}' if eff is not None else '-'} "
            f"| {final.get('status', '?')} |")
    if not any_row:
        lines.append("| (no completed probes) | - | - | - | - | - "
                     "| - | - |")
    return "\n".join(lines)


def main(argv=None) -> int:
    """CLI entry: one streamed reduction, one resumable JSON artifact;
    exit 0 when it PASSED.
    The counterpart of tpu_reductions/bench/stream.py:283."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.stream",
        description="Streaming-pipeline probe: double-buffered chunked "
                    "reduction with sustained-GB/s and chunks/s metrics, "
                    "resume, and a serial stage-then-reduce comparator")
    p.add_argument("--method", type=str, default=None,
                   help="SUM|MIN|MAX (required)")
    p.add_argument("--type", dest="dtype", type=str, default="int")
    p.add_argument("--n", type=int, default=1 << 26)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-bytes", dest="chunk_bytes", type=int,
                   default=None,
                   help="Per-chunk byte bound (default 256 MiB, "
                        "config.stage_chunk_bytes)")
    p.add_argument("--sync-every", dest="sync_every", type=int, default=8,
                   help="Chunks between materializations of the partial "
                        "(the resume checkpoint grain; default 8)")
    p.add_argument("--serial-baseline", action="store_true",
                   help="Also run the serial stage-then-reduce comparator "
                        "and report overlap_efficiency")
    p.add_argument("--no-verify", dest="verify", action="store_false",
                   help="Skip the incremental host oracle")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS)
    p.add_argument("--out", type=str, default=None)
    ns = p.parse_args(argv)
    if ns.method is None:
        p.error("--method={SUM|MIN|MAX} is required")
    if ns.method.upper() not in METHODS:
        p.error(f"--method must be one of {METHODS}, got {ns.method!r}")
    if ns.dtype not in DTYPE_ALIASES:
        p.error(f"unknown --type {ns.dtype!r}")
    if ns.n <= 0:
        p.error("--n must be positive")

    def log(msg):
        print(msg, file=sys.stderr)

    ledger.arm_session("bench.stream",
                       argv=list(argv) if argv else sys.argv[1:])
    from tpu_reductions_torch.exec.core import maybe_arm
    maybe_arm(ns.platform)
    row = run_stream_benchmark(
        ns.method, ns.dtype, ns.n, seed=ns.seed,
        chunk_bytes=ns.chunk_bytes, sync_every=ns.sync_every,
        verify=ns.verify, serial_baseline=ns.serial_baseline,
        out=ns.out, platform=ns.platform, log=log)
    eff = row.get("overlap_efficiency")
    print(f"{row['num_chunks']} chunk(s) x {row['chunk_elems']} elems: "
          f"{row['gbps_sustained']} GB/s sustained, "
          f"{row['chunks_per_s']} chunks/s"
          + (f", overlap x{eff}" if eff else "")
          + f" [{row['status']}]")
    if ns.out:
        print(f"wrote {ns.out}")
    return 0 if row["status"] == "PASSED" else 1


if __name__ == "__main__":
    sys.exit(main())
