"""The window of a collective cell: reduce.c's MPI_Reduce over the host's
cards, one process a card.

The launcher starts one process a card (spawned, each pinned to a block
of the host's cores of its own) and gathers what each hands back. Each
process joins the others through the program's
parallel/mesh.initialize_distributed (NCCL between the cards), places
its ranks (`ranks` over the cards in contiguous blocks, reduce.c's
sendbuf of each drawn on its card from the seed), builds the program's
collective of each row and warms every row. In the window the processes
agree before each round of the rows, over a gloo group on the host and
outside the timed interval, whether the window goes on: process 0
decides, so every window holds whole rounds. Each collective is
awaited; process 0, which holds the root, times it from the call to the
result being ready on its card. Every process keeps a sample of each
row's answers, drawn from the seed alike in all of them (a reservoir of
`keep_per_row` a row), and once the window has closed compares every
rank copy it holds with the reference, which draws every rank's block
again.

Traffic parameters (traffic/<mix>.json):
  bytes_per_dtype     all ranks' payload of one dtype (constants.h)
  warmup_collectives  collectives before the window
  trace_collectives   collectives in the traced slice
  keep_per_row        answers of each row kept for the check
"""

from __future__ import annotations

import dataclasses
import gc
import os
import queue
import random
import socket
import statistics
import sys
import time
import traceback

import torch

from portbench import payload, tracing, yardstick
from portbench.harness import (Outcome, forbidden_modules, load_entry,
                               sync)

WAIT_S = 330          # the longest the launcher waits for its processes
JOIN_S = 60


@dataclasses.dataclass(frozen=True)
class Context:
    """What an entry may know of its row: the configuration, the seed,
    the dtype and the length of a rank's block."""

    config: dict
    seed: int
    dtype: str
    length: int


def port_entry(method: str, mesh, ctx: Context):
    """The program's rooted collective of one row."""
    from tpu_reductions_torch.collectives.core import make_collective_reduce
    return make_collective_reduce(method, mesh, rooted=ctx.config["rooted"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(cell, *, seed: int, seconds: float, trace: bool, platform: str,
        entry=None) -> Outcome:
    """Start one process a card, gather their results, and stop them."""
    import multiprocessing as mp
    world = cell.chips
    os.environ["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1)
                                            // world))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(k, world, port, cell, seed, seconds, trace,
                               platform, entry, q))
             for k in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        until = time.monotonic() + WAIT_S
        while len(got) < world:
            try:
                k, status, body = q.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > until:
                    raise RuntimeError(f"a process of the cell ended with "
                                       f"{dead} or the cell outlasted "
                                       f"{WAIT_S} s")
                continue
            if status != "ok":
                raise RuntimeError(f"process {k} failed:\n{body}")
            got[k] = body
        for p in procs:
            p.join(JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
    return _outcome(cell, [got[k] for k in range(world)])


def _outcome(cell, parts: list) -> Outcome:
    cfg, mix = cell.config, cell.traffic
    lead = parts[0]
    limits = cfg["limits"]
    bad = set()
    for part in parts:
        bad |= {tuple(key) for key in part["failed"]}
    checks = {"exact_mismatch": [sum(p["mismatch"] for p in parts),
                                 limits["exact_mismatch"]],
              "f64_sum_gap": [max(p["gap"] for p in parts),
                              limits["f64_sum_gap"]]}
    window = dict(lead["window"], bytes=lead["window"]["ops"]
                  * mix["bytes_per_dtype"])
    slc = None
    if lead["card"] is not None:
        slc = tracing.Slice(cards=[tracing.Card(**p["card"]) for p in parts],
                            ops=lead["slice_ops"],
                            bytes=lead["slice_ops"] * mix["bytes_per_dtype"],
                            dispatch_s=[], kind=lead["kind"])
    return Outcome(window_start=lead["window_start"], window=window,
                   checks=checks, attempted=lead["window"]["ops"],
                   failed=len(bad), kind=lead["kind"], count=len(parts),
                   memory_peak_bytes=max(p["peak"] for p in parts),
                   slice=slc,
                   forbidden=sorted({m for p in parts
                                     for m in p["forbidden"]}),
                   lines=lead["rows"] + [
                       f"kept {sum(p['kept'] for p in parts)} rank copies "
                       f"of {len(parts)} cards for the check"])


def _worker(k, world, port, cell, seed, seconds, trace, platform, entry,
            q) -> None:
    # each process on a block of the host's cores of its own: unpinned,
    # the four processes' threads migrate over each other's cores and a
    # run's collectives spread several times wider
    cpus = sorted(os.sched_getaffinity(0))
    share = len(cpus) // world
    if share:
        os.sched_setaffinity(0, cpus[k * share:(k + 1) * share])
    try:
        q.put((k, "ok", _work(k, world, port, cell, seed, seconds, trace,
                              platform, entry)))
    except BaseException:
        q.put((k, "error", traceback.format_exc()))
        sys.exit(1)


def _per_second(lat: list) -> str:
    """How many collectives each second of the window completed."""
    counts, at = [], 0.0
    for x in lat:
        at += x
        while len(counts) <= int(at):
            counts.append(0)
        counts[int(at)] += 1
    return "collectives by second: " + " ".join(map(str, counts))


def _row_lines(rows: list, lat: list) -> list:
    """The window's and each row's median and 95th percentile, in ms."""
    out = [f"window: {len(lat)} collectives, median "
           f"{statistics.median(lat) * 1e3!r} ms, p95 "
           f"{yardstick.p95(lat) * 1e3!r} ms"] if lat else []
    for r, (method, dt) in enumerate(rows):
        mine = lat[r::len(rows)]
        if mine:
            out.append(f"row {method} {dt}: {len(mine)} collectives, median "
                       f"{statistics.median(mine) * 1e3!r} ms, p95 "
                       f"{yardstick.p95(mine) * 1e3!r} ms")
    return out


def _work(k, world, port, cell, seed, seconds, trace, platform,
          entry) -> dict:
    import torch.distributed as dist

    from tpu_reductions_torch.parallel.mesh import (build_mesh,
                                                    initialize_distributed,
                                                    leave_distributed)
    cfg, mix = cell.config, cell.traffic
    initialize_distributed(f"localhost:{port}", world, k, platform=platform)
    try:
        ctl = dist.new_group(backend="gloo")
        mesh = build_mesh(num_devices=cfg["ranks"], platform=platform)
        dev = mesh.device
        rows = [tuple(r) for r in cfg["rows"]]
        dtypes = sorted({dt for _, dt in rows})
        length = {dt: mix["bytes_per_dtype"]
                  // (cfg["ranks"] * yardstick.ITEMSIZE[dt]) for dt in dtypes}
        x = {dt: torch.stack([payload.draw(seed, payload.stream_of(dt, r),
                                           length[dt], dt, dev)
                              for r in mesh.owned]) for dt in dtypes}
        make = port_entry if entry is None else load_entry(entry)
        colls = [make(m, mesh, Context(cfg, seed, dt, length[dt]))
                 for m, dt in rows]
        nrows = len(rows)
        for i in range(mix["warmup_collectives"]):
            colls[i % nrows](x[rows[i % nrows][1]])
        keep = mix["keep_per_row"]
        slots = [[torch.empty_like(x[dt]) for _ in range(keep)]
                 for _, dt in rows]
        kept = [[None] * keep for _ in rows]
        seen = [0] * nrows
        rng = random.Random(seed)
        prof = tracing.start(dev.type) if trace else None
        if prof is not None:
            for r, (_, dt) in enumerate(rows):
                colls[r](x[dt])
        sync(dev)
        dist.barrier(group=ctl)
        gc.collect()
        gc.freeze()

        # the window
        flag = torch.zeros(1, dtype=torch.int32)
        mark = tracing.SliceMark() if prof is not None else None
        traced = prof is not None
        slice_ops = 0
        lat = []
        window_start = time.time()
        t_start = time.perf_counter()
        t_last = t_start
        deadline = t_start + seconds
        i = 0
        while True:
            r = i % nrows
            if r == 0:
                with tracing.span("barrier", traced):
                    if k == 0:
                        flag[0] = int(time.perf_counter() < deadline)
                    dist.broadcast(flag, src=0, group=ctl)
                if not int(flag[0]):
                    break
            with tracing.span("collective", traced):
                t0 = time.perf_counter()
                out = colls[r](x[rows[r][1]])
                sync(dev)
                t_last = time.perf_counter()
            lat.append(t_last - t0)
            with tracing.span("collect", traced):
                seen[r] += 1
                slot = (seen[r] - 1 if seen[r] <= keep
                        else rng.randrange(seen[r]))
                if slot < keep:
                    slots[r][slot].copy_(out)
                    kept[r][slot] = seen[r] - 1
                del out
            i += 1
            if traced and i == mix["trace_collectives"]:
                mark.close()
                traced = False
                slice_ops = i
                prof.stop()
        if traced:
            mark.close()
            slice_ops = i
            prof.stop()
        gc.unfreeze()
        sync(dev)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        card = tracing.read_card(prof).to_dict() if prof is not None \
            else None

        # the check, once the program's state is freed
        del x, colls
        ref = cell.module("reference", cfg["name"])
        mismatch, gap, failed = 0, 0.0, []
        for dt in dtypes:
            want = ref.expected(dt, seed, cfg["ranks"], length[dt], dev)
            for r, (method, rdt) in enumerate(rows):
                if rdt != dt:
                    continue
                for s in range(keep):
                    if kept[r][s] is None:
                        continue
                    m, g = ref.compare(method, dt, slots[r][s], want[method])
                    mismatch += m
                    gap = max(gap, g)
                    if m or g > cfg["limits"]["f64_sum_gap"]:
                        failed.append((r, s))
            del want
        dist.barrier(group=ctl)
        return {"window_start": window_start,
                "rows": _row_lines(rows, lat) + [_per_second(lat)],
                "window": {"seconds": t_last - t_start, "ops": i,
                           "latencies_s": lat},
                "peak": peak, "kind": kind, "card": card,
                "slice_ops": slice_ops, "mismatch": mismatch, "gap": gap,
                "failed": failed,
                "kept": sum(len(mesh.owned) for row in kept for s in row
                            if s is not None),
                "forbidden": forbidden_modules()}
    finally:
        leave_distributed()
