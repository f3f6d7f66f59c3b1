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

The rank ladder runs across cards the same way (`run_ladder`): an entry
point given `cards` > 1 (bench/sweep.py, bench/rank_scaling.py) spawns
that many workers once for its whole ladder, each a process of one
group joined as above, which calls the entry's function with the same
arguments; every rung's k ranks lie on the first min(k, C) of them
(parallel/mesh.placement) and rank 0 alone writes the entry's files and
its result. Given a `Witness`, the ladder's rows leave evidence for
their one-card twin (the same function at cards=1): each process's
digest of every row's output and, where the row need not keep one
card's bits, process 0's view; `ladder_agrees` holds them against the
twin's, the same bits where `bits_required` asks (every int32 and
MIN/MAX row, the dd and quantized rings, every reshard step that only
moves data), else within the registry's tolerance (a float SUM through
psum, a reshard step that adds partials).

Worker CLI (launch and run_ladder build it):
    python -m tpu_reductions_torch.bench.multicard --rows=ROWS.json
        --out=DIR --coordinator=HOST:PORT --num-processes=P
        --process-id=I [--platform=cpu]
    python -m tpu_reductions_torch.bench.multicard
        --call=MODULE:FUNCTION --kwargs=KWARGS.json --out=DIR
        --coordinator=HOST:PORT --num-processes=P --process-id=I
        [--platform=cpu] [--evidence=DIR]
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
__all__ = ["LadderFailed", "Witness", "bits_required", "chain_agrees",
           "chain_scalar", "digest", "free_port", "host_cards",
           "ladder_agrees", "launch", "reporting", "run_group", "run_ladder",
           "same_bits", "shared_checkpoint", "spawns", "twin", "twins",
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
        if rec.get("idle"):
            continue            # a process outside the row's mesh
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


def _worker_env(processes: int) -> dict:
    """The workers' environment: the package on PYTHONPATH, and each
    worker's share of the host's cores for its CPU threads (torch's and
    OpenMP's), as torchrun sets OMP_NUM_THREADS: P workers that each take
    every core spin against one another in every host copy (a
    64 MiB torch.cat took 0.6 s in each of 4 gloo workers on 8 cores
    against 0.035 s at 2 threads a worker). An OMP_NUM_THREADS the caller
    set stays."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
    cores = len(os.sched_getaffinity(0))
    env.setdefault("OMP_NUM_THREADS", str(max(1, cores // processes)))
    return env


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
    env = _worker_env(processes)
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


# ---------------------------------------------------------------------------
# the rank ladder across cards
# ---------------------------------------------------------------------------

# a ladder's time limit, by default: bench.rank_scaling's full ladder on
# four cards, set-up and oracles included
LADDER_TIMEOUT_S = 3000.0


class LadderFailed(RuntimeError):
    """A worker of a ladder across cards exited non-zero, was killed at
    the time limit or outlived it: `code` is the first failing worker's
    exit code (1 where it has none). Nothing is re-run on one card.
    No reference analog."""

    def __init__(self, message: str, code: int) -> None:
        super().__init__(message)
        self.code = code


def _group_rank() -> tuple:
    """(this process's rank, the group's size); (0, 1) with no group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def reporting() -> bool:
    """Whether this process writes a ladder's files and result: rank 0
    of the joined group, or the one process.
    No reference analog."""
    return _group_rank()[0] == 0


def host_cards(platform: str, cards: Optional[int] = None) -> int:
    """The cards a ladder spans: `cards`, by default every card of the
    host (device.cards, which CUDA_VISIBLE_DEVICES restricts; one on the
    CPU, where a ladder spans `cards` gloo processes only when asked).
    Inside a joined group it is the group's size, which `cards` must
    match. A host with fewer cards than asked is refused with its reason.
    No reference analog: the JAX mesh takes every device."""
    from tpu_reductions_torch import device as device_mod
    _, world = _group_rank()
    if world > 1:
        if cards not in (None, world):
            raise ValueError(f"--cards={cards} inside a group of {world} "
                             f"processes")
        return world
    if cards is None:
        return max(1, len(device_mod.cards(platform)))
    if cards < 1:
        raise ValueError(f"--cards must be >= 1, got {cards}")
    if platform == "gpu" and cards > 1:
        have = torch.cuda.device_count()
        if cards > have:
            raise RuntimeError(
                f"--cards={cards} but this host has {have} card(s): a "
                f"ladder across cards runs one process a card")
    return cards


def spawns(cards: int) -> bool:
    """Whether an entry point given `cards` spawns its ladder's workers:
    more than one card, and no group joined yet (a worker runs the
    ladder itself).
    No reference analog."""
    return cards > 1 and _group_rank()[1] == 1


def shared_checkpoint(path, meta: dict, *, key_fn):
    """A bench/resume.Checkpoint that only rank 0 of a joined group
    persists, and whose prior rows every process takes from rank 0's
    reading, so that all of them resume the same rows and enter the same
    collectives; the plain Checkpoint with no group.
    No reference analog."""
    from tpu_reductions_torch.bench.resume import Checkpoint
    me, world = _group_rank()
    if world == 1:
        return Checkpoint(path, meta, key_fn=key_fn)
    import torch.distributed as dist

    from tpu_reductions_torch.utils import heartbeat
    ck = Checkpoint(path if me == 0 else None, meta, key_fn=key_fn)
    prior = [ck._prior]
    # redlint: disable=RED025 -- one guard around one wait on the group's other processes, which no LaunchPlan retries: a peer that stalls must end the run with exit 4
    with heartbeat.guard("collective"):
        # redlint: disable=RED016 -- the artifact's prior rows, once: the resume decision every process shares, not a hop of the rank axis
        dist.broadcast_object_list(prior, src=0)
    ck._prior = prior[0]
    return ck


def rung_done() -> None:
    """The end of a rung in a joined group: every process waits here, so
    that a process outside a small rung's mesh waits outside any
    heartbeat guard while the others finish it.
    No reference analog."""
    if _group_rank()[1] > 1:
        import torch.distributed as dist

        from tpu_reductions_torch.utils import heartbeat
        # redlint: disable=RED025 -- one guard around one wait on the group's other processes, which no LaunchPlan retries: a peer that stalls must end the run with exit 4
        with heartbeat.guard("collective"):
            dist.barrier()


def run_ladder(call: str, kwargs: dict, cards: int, *, platform: str,
               work_dir=None, logger: Optional[BenchLogger] = None,
               evidence=None,
               timeout_s: float = LADDER_TIMEOUT_S):
    """Run `call` ("module:function") with `kwargs` in `cards` workers of
    one group joined at a port from the OS (`run_group`: every wait
    bounded, no worker left), one process a card (gloo on the CPU);
    rank 0's log goes to `logger` line by line once the group has ended,
    and its result, through JSON, is returned. `work_dir` keeps the
    workers' arguments, logs and the result (a temporary directory by
    default); `evidence` is the directory of a Witness that every worker
    records into. Raises LadderFailed when a worker failed.
    No reference analog."""
    if work_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_ladder(call, kwargs, cards, platform=platform,
                              work_dir=tmp, logger=logger,
                              evidence=evidence, timeout_s=timeout_s)
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    args, result = work / "ladder_kwargs.json", work / "ladder_result.json"
    atomic_json_dump(args, kwargs)
    result.unlink(missing_ok=True)
    env = _worker_env(cards)
    port = free_port()
    logs = [work / f"ladder{i}.log" for i in range(cards)]
    extra = [f"--evidence={evidence}"] if evidence is not None else []
    group = run_group(
        [[sys.executable, "-m", "tpu_reductions_torch.bench.multicard",
          f"--call={call}", f"--kwargs={args}", f"--out={work}",
          f"--coordinator=127.0.0.1:{port}", f"--num-processes={cards}",
          f"--process-id={i}", f"--platform={platform}", *extra]
         for i in range(cards)], timeout_s, logs=logs, env=env)
    if logger is not None:
        for line in logs[0].read_text().splitlines():
            logger.log(line)
    failed = [(i, rc) for i, rc in enumerate(group["rcs"]) if rc != 0]
    if failed or group["survivors"] or not result.exists():
        tails = "\n".join(f"--- worker {i} (exit {rc}):\n"
                           + logs[i].read_text()[-2000:]
                           for i, rc in enumerate(group["rcs"]))
        code = next((rc for _, rc in failed if rc), 1)
        raise LadderFailed(
            f"{call} across {cards} card(s): worker exits {group['rcs']}, "
            f"survivors {group['survivors']}\n{tails}", code)
    return json.loads(result.read_text())


class Witness:
    """The evidence a ladder's rows leave for their one-card twin, under
    `root`: each process appends to `process<I>.jsonl` one record a row,
    its stage and key, `digest`'s fields (the row's view is the whole
    result: a replicated collective's row, rank 0's row of a quantized
    curve cell, a reshard cell's every block), whether the row must keep
    one card's bits (`exact`), its method, dtype and n, and, where it
    need not, process 0 saves its view (`kept`).
    No reference analog."""

    def __init__(self, root) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.process = _group_rank()[0]
        self.path = self.root / f"process{self.process}.jsonl"
        self.path.write_text("")
        self._seen: dict = {}

    def keep(self, out, coll, chain=None) -> None:
        """run_collective_benchmark's on_result: the verified output of
        a collective row, for `collective`. No reference analog."""
        self._seen = {"out": out, "coll": coll}

    def collective(self, stage: str, key, results: list) -> None:
        """Record the collective row `keep` saw (none for a process
        outside its mesh, or for rows resumed from an artifact).
        No reference analog."""
        seen, self._seen = self._seen, {}
        if not seen or not results:
            return
        head = results[0]
        self.record(stage, key, _views(seen["out"], seen["coll"]),
                    seen["coll"].mesh,
                    exact=bits_required(head.method, head.dtype,
                                        head.algorithm),
                    replicated=bool(seen["coll"].replicated),
                    method=head.method, dtype=head.dtype, n=head.n)

    def record(self, stage: str, key, views: list, mesh, *, exact: bool,
               replicated: bool, method: str, dtype: str, n: int) -> None:
        """Append one row's record (class docstring); `mesh` the row's.
        No reference analog."""
        rec = {"stage": stage, "key": list(key), "exact": bool(exact),
               "sha": [_sha(v) for v in views], "owned": list(mesh.owned),
               "k": int(mesh.k), "replicated": bool(replicated),
               "process": self.process, "members": len(mesh.members),
               "method": method, "dtype": dtype, "n": int(n),
               "kept": None}
        if not exact and self.process == 0:
            rec["kept"] = (f"{stage}-" + "-".join(map(str, key))
                           + ".npy")
            np.save(self.root / rec["kept"], np.asarray(views[0]))
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _evidence(root) -> dict:
    """(stage, key) -> every process's record, process 0's first."""
    recs: dict = {}
    for path in sorted(Path(root).glob("process*.jsonl"),
                       key=lambda p: int(p.stem[len("process"):])):
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            recs.setdefault((rec["stage"], tuple(rec["key"])),
                            []).append(rec)
    return recs


def ladder_agrees(ladder_dir, twin_dir) -> list:
    """Each row of a ladder's evidence against its one-card twin's:
    [(stage, key, ok, words)] in the twin's order; ok when every process
    of the ladder recorded the row and gave the twin's bits where either
    side's row must keep them (`exact`: the twin's whole view against
    each process's, as `same_bits` holds them), else when process 0's
    view lies within the registry's tolerance of the twin's
    (`within_tolerance`). A row of the ladder that the twin lacks fails.
    No reference analog."""
    ladder, twin = _evidence(ladder_dir), _evidence(twin_dir)
    out = []
    for key, (want, *_) in twin.items():
        recs = ladder.get(key, [])
        if (not recs or recs[0]["process"] != 0
                or len(recs) != recs[0]["members"]):
            out.append((*key, False, f"{len(recs)} RECORD(S) in the "
                        f"ladder, not one from each process of the row"))
            continue
        if want["exact"] or any(r["exact"] for r in recs):
            ok = (want["replicated"] and all(
                r["replicated"] and r["sha"] == want["sha"] for r in recs))
            words = (f"same bits as one card in {len(recs)} process(es)"
                     if ok else "BITS DIFFER from one card")
        else:
            ok, diff = within_tolerance(
                [np.load(Path(twin_dir) / want["kept"])],
                np.load(Path(ladder_dir) / recs[0]["kept"]),
                want["method"], want["dtype"], want["n"])
            words = (f"max |diff| {diff:.3e} vs one card, within "
                     f"registry.tolerance" if ok else
                     f"max |diff| {diff:.3e} OVER registry.tolerance")
        out.append((*key, ok, words))
    for key in ladder:
        if key not in twin:
            out.append((*key, False, "NO TWIN on one card"))
    return out


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
                if not seen:
                    # outside the row's mesh: no rank, no collective
                    for i in idx:
                        f.write(json.dumps({"row": i, "idle": True,
                                            "results": []}) + "\n")
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


def _ladder_worker(ns) -> int:
    """One worker of run_ladder: join the group (its own card, NCCL; gloo
    on the CPU), call the function with --kwargs (a logger on stdout for
    rank 0, silent elsewhere; a Witness under --evidence), and write
    rank 0's result as JSON."""
    import importlib

    from tpu_reductions_torch import device as device_mod
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.parallel.mesh import (initialize_distributed,
                                                    leave_distributed)
    module, name = ns.call.split(":")
    fn = getattr(importlib.import_module(module), name)
    kwargs = json.loads(Path(ns.kwargs).read_text())
    maybe_arm(ns.platform)
    device_mod.resolve(ns.platform, process_id=ns.process_id,
                       num_processes=ns.num_processes)
    joined = initialize_distributed(
        coordinator_address=ns.coordinator, num_processes=ns.num_processes,
        process_id=ns.process_id, platform=ns.platform)
    try:
        rank0 = ns.process_id == 0
        kwargs["logger"] = BenchLogger(
            None, None, console=sys.stdout if rank0 else io.StringIO())
        if ns.evidence:
            kwargs["witness"] = Witness(ns.evidence)
        result = fn(**kwargs)
        if rank0:
            atomic_json_dump(Path(ns.out) / "ladder_result.json",
                             json.loads(json.dumps(result, default=str)))
    finally:
        if joined:
            leave_distributed()
    return 0


def main(argv=None) -> int:
    """The worker: join, run every row of --rows and write
    `DIR/process<I>.jsonl`, or, with --call, run one entry point's ladder
    (run_ladder); exit 0, or 1 with its error.
    No reference analog."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.multicard",
        description="one worker of a multi-process collective run")
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--rows")
    what.add_argument("--call")
    p.add_argument("--kwargs")
    p.add_argument("--evidence")
    p.add_argument("--out", required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--platform", default="gpu", choices=("gpu", "cpu"))
    ns = p.parse_args(argv)
    try:
        if ns.call:
            return _ladder_worker(ns)
        return _worker(ns)
    except Exception as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
