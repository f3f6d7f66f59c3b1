"""The window of a single-device reduction cell: the SDK sample's timing
on the port's main path.

Set-up draws the payloads on the card from the seed, stages each row's
copies through the program's `stage_fn` and warms every row. The window
then calls the program's `reduce_fn` once a call, the configuration's
rows in turn, each row rotating through its staged payloads, and awaits
each call: synchronise, reduce, synchronise, as reduction.cpp times it.
A call's latency runs from the call to its result being ready on the
card. The answers stay on the card and are fetched in batches, between
calls; once the window has closed every answer is compared with the
configuration's reference, worked out from the raw payloads.

Traffic parameters (traffic/<mix>.json):
  n              {dtype: elements of one payload}
  payloads       payloads a dtype, each staged once per row
  warmup_calls   calls before the window
  trace_calls    calls in the traced slice, at the start of the window
  collect_every  calls between two fetches of the answers
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench import payload, tracing, yardstick
from portbench.harness import Outcome, load_entry, sync


def port_entry(method: str, n: int, dtype: str, config: dict,
               device: torch.device):
    """The program's (stage_fn, reduce_fn) of one row."""
    from tpu_reductions_torch.ops.kernel_reduce import make_staged_reduce
    return make_staged_reduce(method, n, dtype, threads=config["threads"],
                              max_blocks=config["max_blocks"],
                              kernel=config["kernel"], device=device)


def run(cell, *, seed: int, seconds: float, trace: bool, platform: str,
        entry=None) -> Outcome:
    cfg, mix = cell.config, cell.traffic
    device = torch.device("cuda", 0) if platform == "gpu" else \
        torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rows = [tuple(r) for r in cfg["rows"]]
    make = port_entry if entry is None else load_entry(entry)

    # set-up: the payloads, each row's staged copies and its reduce_fn
    raw = {dt: [payload.draw(seed, payload.stream_of(dt, p), mix["n"][dt],
                             dt, device) for p in range(mix["payloads"])]
           for dt in sorted({dt for _, dt in rows})}
    fns, staged = [], []
    for method, dt in rows:
        stage_fn, reduce_fn = make(method, mix["n"][dt], dt, cfg, device)
        fns.append(reduce_fn)
        staged.append([stage_fn(x) for x in raw[dt]])
    nrows, npay = len(rows), mix["payloads"]
    for i in range(mix["warmup_calls"]):
        r = i % nrows
        fns[r](staged[r][(i // nrows) % npay])
    sync(device)
    prof = tracing.start(device.type) if trace else None
    if prof is not None:
        for i in range(nrows * npay):
            r = i % nrows
            fns[r](staged[r][(i // nrows) % npay])
        sync(device)
    gc.collect()
    gc.freeze()

    # the window
    lat, disp = [], []
    used = [[] for _ in rows]        # payload index of each call, by row
    pending = [[] for _ in rows]     # answers not yet fetched, by row
    answers = [[] for _ in rows]
    mark = tracing.SliceMark() if prof is not None else None
    traced = prof is not None
    slice_calls = 0
    window_start = time.time()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        r = i % nrows
        p = (i // nrows) % npay
        x2d = staged[r][p]
        with tracing.span("call", traced):
            t0 = time.perf_counter()
            out = fns[r](x2d)
            t1 = time.perf_counter()
        with tracing.span("sync", traced):
            sync(device)
            t2 = time.perf_counter()
        with tracing.span("rotate", traced):
            lat.append(t2 - t0)
            disp.append(t1 - t0)
            pending[r].append(out)
            used[r].append(p)
            i += 1
        if i % mix["collect_every"] == 0:
            with tracing.span("collect", traced):
                _fetch(pending, answers)
        if traced and i == mix["trace_calls"]:
            mark.close()
            traced = False
            slice_calls = i
            prof.stop()
        if t2 >= deadline:
            break
    t_end = t2
    if traced:
        mark.close()
        slice_calls = i
        prof.stop()
    gc.unfreeze()
    _fetch(pending, answers)
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    payload_bytes = [mix["n"][dt] * yardstick.ITEMSIZE[dt] for _, dt in rows]
    window = {"seconds": t_end - t_start, "ops": i, "latencies_s": lat,
              "bytes": sum(payload_bytes[k % nrows] for k in range(i))}
    slc = None
    if prof is not None:
        slc = tracing.Slice(
            cards=[tracing.read_card(prof)], ops=slice_calls,
            bytes=sum(yardstick.reduction_bytes(mix["n"][rows[k % nrows][1]],
                                                rows[k % nrows][1])
                      for k in range(slice_calls)),
            dispatch_s=disp[:slice_calls], kind=kind)

    # the check, once the program's state is freed
    del fns, staged, out, x2d
    ref = cell.module("reference", cfg["name"])
    want = {}
    compared = []
    for r, (method, dt) in enumerate(rows):
        pairs = []
        for got, p in zip(answers[r], used[r]):
            if (method, dt, p) not in want:
                want[(method, dt, p)] = ref.expected(method, raw[dt][p])
            pairs.append((got, want[(method, dt, p)]))
        compared.append((method, dt, pairs))
    checks, failed = ref.checks(compared, cfg["limits"])
    failed += i - sum(len(a) for a in answers)
    return Outcome(window_start=window_start, window=window, checks=checks,
                   attempted=i, failed=failed, kind=kind, count=1,
                   memory_peak_bytes=peak, slice=slc,
                   lines=_row_lines(rows, lat, disp))


def _row_lines(rows: list, lat: list, disp: list) -> list:
    """The window's and each row's median and 95th percentile, and each
    row's mean dispatch, in us."""
    out = [f"window: {len(lat)} calls, median "
           f"{statistics.median(lat) * 1e6!r} us, p95 "
           f"{yardstick.p95(lat) * 1e6!r} us"]
    for r, (method, dt) in enumerate(rows):
        mine, host = lat[r::len(rows)], disp[r::len(rows)]
        if mine:
            out.append(f"row {method} {dt}: {len(mine)} calls, median "
                       f"{statistics.median(mine) * 1e6!r} us, p95 "
                       f"{yardstick.p95(mine) * 1e6!r} us, mean dispatch "
                       f"{sum(host) / len(host) * 1e6!r} us")
    return out


def _fetch(pending: list, answers: list) -> None:
    """Move the answers waiting on the card to the host, one copy a row."""
    for r, outs in enumerate(pending):
        if outs:
            answers[r].extend(torch.stack(outs).cpu().tolist())
            outs.clear()
