"""Collective rows with one process per card, held against one card.

No reference analog as a module: the JAX package runs the same rows
through its collective CLI on every host of a slice
(tpu_reductions/bench/collective_driver.py:585, docs/MULTIHOST.md), one
process per host; this module runs the port's collective path that way
on one host, one process per card, and holds each row against its
one-card twin, the same k and n in one process.

`launch(rows, processes)` spawns `processes` workers on a port from the
OS (`run_group`: every wait bounded, no worker outlives it), each a
process of the collective CLI's bring-up (collective_driver.bring_up:
its own card, NCCL between the cards; gloo with --platform=cpu), which
runs every row, a list of collective-CLI arguments, through
`run_collective_benchmark`. Consecutive rows that differ only in their
timing run as one, over one payload, warm-up and oracle, timed each way.
Per row a worker writes its result rows (or its `error`, after which the
next row runs), the digest of its verified output (`digest`: SHA-256 of
this process's view of each plane) and, on a chained row, the timed
chain's scalar, which collective_driver has already held against the
same chain run one by one; process 0 also keeps the view of a row whose
bits may differ (`row<i>.npy`), for `within_tolerance`. `twins(rows)`
runs the rows in this process, grouped the same way, and keeps their
full views and chain scalars; `same_bits` and `chain_agrees` hold a
worker's digests and scalars against them, and `bits_required` says
which rows must give the same bits across placements: every int32 and
MIN/MAX row and the ring paths (the dd ring, the quantized ring), whose
combine order is the ranks', not the processes'. A float SUM through
psum combines a card's rows first and then the cards', so it is held to
the registry's tolerance instead.

Worker CLI (launch builds it):
    python -m tpu_reductions_torch.bench.multicard --rows=ROWS.json
        --out=DIR --coordinator=HOST:PORT --num-processes=P
        --process-id=I [--platform=cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from tpu_reductions_torch.bench.collective_driver import (bits_required,
                                                          chain_agrees)
from tpu_reductions_torch.utils.jsonio import atomic_json_dump
from tpu_reductions_torch.utils.logging import BenchLogger

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
__all__ = ["bits_required", "chain_agrees", "chain_scalar", "digest",
           "free_port", "launch", "run_group", "same_bits", "twin", "twins",
           "within_tolerance"]


def _views(out, coll) -> list:
    """This process's view of each plane of a collective's output."""
    from tpu_reductions_torch.collectives import local_view_and_selection
    planes = out if isinstance(out, tuple) else (out,)
    return [np.ascontiguousarray(local_view_and_selection(p, coll)[0])
            for p in planes]


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digest(views: list, coll) -> dict:
    """The digest of a collective's verified output as this process sees
    it (`views`, one a plane): the SHA-256 of each view, with the ranks
    it holds and whether the output is replicated (the view is then one
    rank's row).
    No reference analog."""
    return {"sha": [_sha(v) for v in views],
            "owned": list(coll.mesh.owned), "k": coll.mesh.k,
            "replicated": bool(coll.replicated)}


def same_bits(full_views: list, recs: list) -> bool:
    """Whether every worker's digest in `recs` matches the one-card
    twin's full views: the whole view where replicated (hashed once),
    else the slices of the ranks each worker holds.
    No reference analog."""
    whole = None
    for rec in recs:
        if rec["replicated"]:
            whole = whole or [_sha(v) for v in full_views]
            want = whole
        else:
            want = [_sha(v.reshape(rec["k"], -1)[rec["owned"]].reshape(-1))
                    for v in full_views]
        if want != rec["sha"]:
            return False
    return True


def within_tolerance(full_views: list, kept: np.ndarray, method: str,
                     dtype: str, n: int) -> tuple:
    """(ok, max |difference|): a worker's kept view against the one-card
    twin's within ops/registry.tolerance, scaled as
    collective_driver._check scales its float tolerance (by the largest
    magnitude, at least 1).
    No reference analog."""
    from tpu_reductions_torch.ops.registry import tolerance
    want = full_views[0].astype(np.float64)
    got = np.asarray(kept).astype(np.float64)
    tol = tolerance(method, dtype, n)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    diff = float(np.abs(got - want).max()) if want.size else 0.0
    return got.shape == want.shape and diff <= tol * scale, diff


def _chain_record(scalar: Optional[torch.Tensor]) -> Optional[dict]:
    """A chain scalar as JSON: its bytes in hex and its dtype."""
    if scalar is None:
        return None
    flat = scalar.detach().cpu().reshape(1)
    return {"bits": flat.view(torch.uint8).numpy().tobytes().hex(),
            "dtype": str(flat.dtype).removeprefix("torch.")}


def chain_scalar(rec: dict) -> torch.Tensor:
    """The chain scalar a worker's record holds (`chain`), as a tensor.
    No reference analog."""
    chain = rec["chain"]
    return torch.frombuffer(bytearray.fromhex(chain["bits"]),
                            dtype=getattr(torch, chain["dtype"])).clone()


def _groups(cfgs: list) -> list:
    """(row indices, config, timings): consecutive rows that differ only
    in their timing run as one, over one payload, warm-up and oracle."""
    groups: list = []
    for i, cfg in enumerate(cfgs):
        if groups:
            idx, head, timings = groups[-1]
            if (cfg.timing not in timings
                    and dataclasses.replace(cfg, timing=head.timing) == head):
                idx.append(i)
                timings.append(cfg.timing)
                continue
        groups.append(([i], cfg, [cfg.timing]))
    return groups


def _run_rows(cfg, timings: list, log) -> tuple:
    """One group's rows through run_collective_benchmark: its results
    split by timing, the views of its verified output, the collective,
    the chain scalar and its seconds."""
    from tpu_reductions_torch.bench import collective_driver as cd
    seen: dict = {}

    def keep(out, coll, chain):
        seen.update(views=_views(out, coll), coll=coll, chain=chain)
    t0 = time.perf_counter()
    # redlint: disable=RED018 -- the group's host seconds (payload, oracle, verification included) for the caller's budget; its device times are collective_driver's rows
    results = cd.run_collective_benchmark(
        cfg, logger=BenchLogger(None, None, console=log), on_result=keep,
        timings=timings)
    seconds = time.perf_counter() - t0
    per = len(results) // len(timings)
    split = [results[j * per:(j + 1) * per] for j in range(len(timings))]
    return split, seen, seconds


def twins(rows: List[List[str]], platform: str = "gpu") -> Iterator[dict]:
    """Every row in this process (its one-card twin), rows that differ
    only in their timing run once and timed both ways; yields, row by
    row and a group at a time, its result rows, the full views of its
    verified output, its chain scalar (None unless chained), the seconds
    of its group (on its first row, 0.0 on the others) and its log.
    No reference analog."""
    from tpu_reductions_torch.config import parse_collective
    cfgs = [parse_collective(list(argv) + [f"--platform={platform}"])
            for argv in rows]
    for idx, cfg, timings in _groups(cfgs):
        log = io.StringIO()
        split, seen, seconds = _run_rows(cfg, timings, log)
        for j, (timing, results) in enumerate(zip(timings, split)):
            yield {"results": [r.to_dict() for r in results],
                   "views": seen["views"],
                   "chain": seen["chain"] if timing == "chained" else None,
                   "seconds": seconds if j == 0 else 0.0,
                   "log": log.getvalue()}


def twin(argv: List[str], platform: str = "gpu") -> dict:
    """One row in this process (its one-card twin): `twins` of one row.
    No reference analog."""
    return next(twins([argv], platform))


def _ephemeral_low() -> int:
    """The lowest port the OS hands out to outgoing connections."""
    try:
        text = Path("/proc/sys/net/ipv4/ip_local_port_range").read_text()
        return int(text.split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A TCP port free on localhost now, below the OS's ephemeral range:
    the workers' store clients retry their connect until process 0
    listens, and a retry from an ephemeral port can connect to itself
    (source port = the coordinator's port), after which process 0's bind
    fails with EADDRINUSE. A port outside that range cannot be taken so.
    No reference analog."""
    import random
    low = min(_ephemeral_low(), 65536)
    ports = list(range(max(1024, low - 12288), low))
    random.shuffle(ports)
    for port in ports[:256]:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port below the ephemeral range")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def run_group(commands: List[List[str]], timeout_s: float, *,
              logs: Optional[list] = None, env: Optional[dict] = None,
              peer_grace_s: float = 30.0) -> dict:
    """Start every command in a session of its own, from the repository's
    root, and wait for them all: at most `timeout_s`, and at most
    `peer_grace_s` past the first that fails (its peers would wait on it
    until their collective timeout). What is left then is killed with
    its process group. Output goes to the files `logs` names, stderr
    merged, else is captured. Returns {"rcs": exit codes (None: not
    reaped), "outs": (stdout, stderr) per command, "survivors": pids
    still alive (none, unless the OS failed to reap a killed one)}.
    No reference analog."""
    sinks = []
    procs = []
    try:
        for i, cmd in enumerate(commands):
            if logs is not None:
                out = open(logs[i], "w+b")
                err = subprocess.STDOUT
            else:
                out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            sinks.append((out, err))
            procs.append(subprocess.Popen(
                cmd, cwd=str(PACKAGE_ROOT), env=env, stdout=out, stderr=err,
                start_new_session=True))
        deadline = time.monotonic() + timeout_s
        rcs: list = [None] * len(procs)
        while any(rc is None for rc in rcs):
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                deadline = min(deadline, time.monotonic() + peer_grace_s)
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=30))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        outs = []
        for out, err in sinks:
            texts = []
            for f in (out, err):
                if f == subprocess.STDOUT:
                    texts.append("")
                    continue
                f.seek(0)
                texts.append(f.read().decode(errors="replace"))
                f.close()
            outs.append(tuple(texts))
    return {"rcs": rcs, "outs": outs,
            "survivors": [p.pid for p in procs if _alive(p.pid)]}


def launch(rows: List[List[str]], processes: int, out_dir, *,
           platform: str = "gpu", timeout_s: float = 600.0) -> dict:
    """Run `rows` (collective-CLI arguments without the process flags)
    in `processes` workers joined at a port from the OS (`run_group`);
    returns {"rcs": exit codes, "records": per process, its per-row
    records, "kept": row index -> process 0's kept view, "seconds",
    "survivors"}.
    No reference analog."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    atomic_json_dump(out / "rows.json", rows)
    for old in out.glob("row*.npy"):
        old.unlink()
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
    for i in range(processes):
        (out / f"process{i}.jsonl").unlink(missing_ok=True)
    t0 = time.perf_counter()
    group = run_group(
        [[sys.executable, "-m", "tpu_reductions_torch.bench.multicard",
          f"--rows={out / 'rows.json'}", f"--out={out}",
          f"--coordinator=127.0.0.1:{port}", f"--num-processes={processes}",
          f"--process-id={i}", f"--platform={platform}"]
         for i in range(processes)], timeout_s,
        logs=[out / f"process{i}.log" for i in range(processes)], env=env)
    seconds = time.perf_counter() - t0
    records = []
    for i in range(processes):
        path = out / f"process{i}.jsonl"
        records.append([json.loads(line) for line in
                        path.read_text().splitlines()]
                       if path.exists() else [])
    files: dict = {}
    kept = {}
    for rec in records[0] if records else []:
        if rec.get("kept"):
            name = rec["kept"]
            if name not in files:
                files[name] = np.load(out / name)
            kept[rec["row"]] = files[name]
    return {"rcs": group["rcs"], "records": records, "kept": kept,
            "seconds": seconds, "survivors": group["survivors"]}


def _worker(ns) -> int:
    from tpu_reductions_torch.bench import collective_driver as cd
    from tpu_reductions_torch.config import parse_collective
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.parallel.mesh import leave_distributed
    rows = json.loads(Path(ns.rows).read_text())
    flags = [f"--coordinator={ns.coordinator}",
             f"--num-processes={ns.num_processes}",
             f"--process-id={ns.process_id}", f"--platform={ns.platform}"]
    cfgs = [parse_collective(list(argv) + flags) for argv in rows]
    maybe_arm(ns.platform)
    joined, reporting = cd.bring_up(cfgs[0])
    path = Path(ns.out) / f"process{ns.process_id}.jsonl"
    try:
        with open(path, "w") as f:
            for idx, cfg, timings in _groups(cfgs):
                log = io.StringIO()
                try:
                    split, seen, seconds = _run_rows(cfg, timings, log)
                except Exception as e:    # the rows fail; the next run
                    traceback.print_exc()
                    for i in idx:
                        f.write(json.dumps(
                            {"row": i,
                             "error": f"{type(e).__name__}: {e}"}) + "\n")
                    f.flush()
                    continue
                kept = None
                head = split[0][0] if split[0] else None
                if (ns.process_id == 0 and head is not None
                        and seen["coll"].replicated
                        and not bits_required(cfg.method, cfg.dtype,
                                              head.algorithm)):
                    kept = f"row{idx[0]}.npy"
                    np.save(Path(ns.out) / kept, seen["views"][0])
                dig = digest(seen["views"], seen["coll"])
                for i, timing, results in zip(idx, timings, split):
                    rec = {"row": i, **dig,
                           "results": [r.to_dict() for r in results],
                           "chain": _chain_record(
                               seen["chain"] if timing == "chained"
                               else None),
                           "seconds": seconds if i == idx[0] else 0.0,
                           "kept": kept,
                           "log": log.getvalue() if reporting else ""}
                    f.write(json.dumps(rec) + "\n")
                seen.clear()
                f.flush()
    finally:
        if joined:
            leave_distributed()
    return 0


def main(argv=None) -> int:
    """The worker: join, run every row of --rows, write
    `DIR/process<I>.jsonl`; exit 0, or 1 with its error.
    No reference analog."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.multicard",
        description="one worker of a multi-process collective run")
    p.add_argument("--rows", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--platform", default="gpu", choices=("gpu", "cpu"))
    ns = p.parse_args(argv)
    try:
        return _worker(ns)
    except Exception as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
