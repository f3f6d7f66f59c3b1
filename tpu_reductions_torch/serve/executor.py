"""The serving path's only module that touches the device.

The counterpart of tpu_reductions/serve/executor.py. A coalesced batch of
k compatible requests (one method, dtype and n) runs as one stacked
launch: the payloads stack into a (k, n) tensor, rows pad to the next
power of two with the op's identity (ops/registry.py), one host-to-device
copy moves the stack, and one torch reduction along dim 1 on the card
gives all k scalars: the counterpart of the JAX package's jitted
`jnp_reduce(x, axis=1)`, which is XLA there and no Pallas kernel. SUM
adds int32 in int32 (wrapping mod 2^32, as the oracle does), float32 and
float64 in their own width, and bfloat16 in float32 (registry.accum_dtype,
the JAX row-reduce's accumulator). Each request's scalar is verified
against the host oracle on its own payload.

The copy: admission caps a request and the batcher a stack at 512 MiB
(serve/engine.py, serve/coalesce.py), which is utils/staging's chunking
threshold, so `maybe_chunked_stage` leaves every batch to the one-shot
pageable copy; `last_route` records which route a batch took.

Threads and the card: the engine's worker thread calls in here while
client threads only submit. Every launch sets the card as the thread's
device and runs on the device's default stream, named explicitly
(`_on_card`); nothing here runs under an engine lock.

Each launch is one LaunchPlan through exec/core.run, with the
`serve.batch` fault point and one compile-seam span for the first launch
of each bucket key. `seconds` accumulates the host seconds of each
batch's steps (fill, stack, copy, reduce, verify) and `launches` counts
launches per surface.

The shard route and the drain's reshard, on the rank axis of one card
(docs/PORT.md "The fleet on one card"): `BatchExecutor(ranks=K)` reports
`device_count: K`, and the engine then sends a request over the shard
threshold to `run_sharded`, which splits the payload into K contiguous
shards, folds each chunk by chunk (every host-to-device copy bounded by
ops/stream.plan_chunks) into its row of one (K, width*8, 128) tensor on
the device, and combines the K rows with the collective that
collectives/algorithms.select_algorithm names (`collective.select`,
`collective.launch` and `collective.done` events): the JAX package's
per-device folds and XLA collective over a device mesh, with the ranks
rows of one tensor, as the collective driver's are. The fold is one torch
reduction over a chunk's blocks, as JAX's `_jit_shard_fold` is jnp under
jit; no kernel of the repository runs here. `last_shard` keeps the
seconds of the last sharded request's fill, fold, combine and verify.
`run_reshard` runs a planner program (reshard/primitives.execute_plan) on
a rank mesh of the same device, the drain's device seam.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_reductions_torch.faults.inject import fault_point

STEPS = ("fill", "stack", "copy", "reduce", "verify")


def _bucket(k: int) -> int:
    """The next power of two >= k."""
    b = 1
    while b < k:
        b <<= 1
    return b


# (method, dtype, n, padded k) keys whose first launch was bracketed in a
# compile-seam span
_observed_buckets: set = set()


def _fill(n: int, dtype: str, seed: int) -> torch.Tensor:
    """One request's payload as a flat CPU tensor: the native filler's, or
    utils/rng's (bfloat16, or without the library), as JAX fills it."""
    from tpu_reductions_torch.ops import oracle as oracle_mod
    from tpu_reductions_torch.utils.rng import host_data
    x = oracle_mod.native_fill(n, dtype, rank=0, seed=seed)
    if x is None:
        return host_data(n, dtype, rank=0, seed=seed)
    return torch.from_numpy(x)


def _verified(value, host, method: str, dtype: str, n: int,
              verify_as: Optional[str] = None) -> Dict:
    from tpu_reductions_torch.ops import oracle as oracle_mod
    ok, diff = oracle_mod.verify(value, host, verify_as or method, dtype, n)
    return {"result": float(np.asarray(value, dtype=np.float64)),
            "ok": bool(ok),
            "host": float(np.asarray(host, dtype=np.float64)),
            "diff": float(diff)}


class BatchExecutor:
    """Stacked launches for the serving engine (module docstring). The
    engine calls `capabilities()`, `run_batch(...)` and `run_stream(...)`.
    `platform` is "gpu" (the card, the default) or "cpu"; constructing
    one touches no device."""

    def __init__(self, platform: str = "gpu", ranks: int = 1) -> None:
        if ranks < 1:
            raise ValueError(f"ranks must be >= 1, got {ranks}")
        self.platform = platform
        self.ranks = int(ranks)
        self.last_shard: Optional[Dict[str, float]] = None
        self._device: Optional[torch.device] = None
        self._caps: Optional[dict] = None
        self.seconds: Dict[str, float] = dict.fromkeys(STEPS, 0.0)
        self.launches: Counter = Counter()
        self.last_route: Optional[str] = None

    @property
    def device(self) -> torch.device:
        """The card, or the CPU when asked; resolving raises without a
        card (no fallback)."""
        if self._device is None:
            from tpu_reductions_torch import device as device_mod
            dev = device_mod.resolve(self.platform)
            if dev.type == "cuda" and dev.index is None:
                # the index the worker thread sets as its device
                dev = torch.device("cuda", torch.cuda.current_device())
            self._device = dev
        return self._device

    def capabilities(self) -> dict:
        """{'backend', 'supports_f64', 'device_count'}: the card adds
        float64 natively and so does the CPU; `device_count` is the
        ranks of the shard route (the engine shards only above 1)."""
        if self._caps is None:
            self._caps = {"backend": self.device.type,
                          "supports_f64": True,
                          "device_count": self.ranks}
        return self._caps

    @contextlib.contextmanager
    def _on_card(self):
        """The calling thread's device set to the card, its work on the
        card's default stream (a no-op on the CPU)."""
        dev = self.device
        if dev.type != "cuda":
            yield
            return
        torch.cuda.set_device(dev)
        with torch.cuda.stream(torch.cuda.default_stream(dev)):
            yield

    def _sync(self) -> None:
        from tpu_reductions_torch import device as device_mod
        device_mod.synchronize(self.device)

    def reset_counts(self) -> None:
        """Zero `seconds` and `launches`."""
        self.seconds = dict.fromkeys(STEPS, 0.0)
        self.launches = Counter()

    def run_batch(self, method: str, dtype: str, n: int,
                  seeds: List[int]) -> List[Dict]:
        """Execute one coalesced batch; one dict per request in seed order:
        {'result', 'ok', 'host', 'diff'}. Raises on device failure after
        the retry classification; the engine contains it to the batch."""
        from tpu_reductions_torch.config import DTYPE_ALIASES, FAMILY_METHODS
        from tpu_reductions_torch.exec import core as exec_core
        from tpu_reductions_torch.exec.plan import launch_plan
        from tpu_reductions_torch.ops import oracle as oracle_mod
        from tpu_reductions_torch.ops.registry import get_op
        from tpu_reductions_torch.utils.staging import maybe_chunked_stage

        method = method.upper()
        dtype = DTYPE_ALIASES.get(dtype, dtype)
        if method in FAMILY_METHODS:
            return self._run_family_batch(method, dtype, n, seeds)

        fault_point("serve.batch")

        op = get_op(method)
        t0 = time.perf_counter()
        payloads = [_fill(n, dtype, s) for s in seeds]
        t1 = time.perf_counter()
        k = len(payloads)
        kb = _bucket(k)
        stacked = torch.stack(payloads)
        if kb > k:
            pad = torch.full((kb - k, n), op.identity(stacked.dtype),
                             dtype=stacked.dtype)
            stacked = torch.cat([stacked, pad])
        t2 = time.perf_counter()
        marks = {}
        surface = f"serve-bucket/{method.lower()}"

        def launch():
            self.launches[surface] += 1
            with self._on_card():
                c0 = time.perf_counter()
                x = maybe_chunked_stage(stacked, kb, n,
                                        op.identity(stacked.dtype),
                                        self.device)
                self.last_route = "pageable" if x is None else "chunked"
                if x is None:
                    # redlint: disable=RED015 -- the one-shot copy only where maybe_chunked_stage judged the stack under the staging threshold
                    x = stacked.to(self.device)
                # redlint: disable=RED018 -- the copy's host seconds are serving latency the client sees (per-step attribution), not a kernel time
                self._sync()
                c1 = time.perf_counter()
                vals = oracle_mod.host_value(op.reduce_dim(x, 1))
                c2 = time.perf_counter()
            marks["copy"], marks["reduce"] = c1 - c0, c2 - c1
            return vals

        plan = launch_plan(surface, "serve", lambda ctx: launch(),
                           timing="serve", heartbeat_phase="serve",
                           retry=True, drain=True, method=method,
                           dtype=dtype, n=n, batch=kb)
        bucket_key = (method, dtype, n, kb)
        if bucket_key not in _observed_buckets:
            _observed_buckets.add(bucket_key)
            with exec_core.observe_compile(plan.surface, dtype=dtype,
                                           n=n, batch=kb):
                vals = exec_core.run(plan)[:k]
        else:
            vals = exec_core.run(plan)[:k]

        t3 = time.perf_counter()
        out = [_verified(vals[i], oracle_mod.host_reduce(payloads[i],
                                                         method),
                         method, dtype, n)
               for i in range(k)]
        t4 = time.perf_counter()
        self._account(fill=t1 - t0, stack=t2 - t1, copy=marks["copy"],
                      reduce=marks["reduce"], verify=t4 - t3)
        return out

    def _account(self, **steps) -> None:
        for name, s in steps.items():
            self.seconds[name] += s

    # segments per served segmented request
    _SERVE_SEGMENTS = 8

    def _run_family_batch(self, method: str, dtype: str, n: int,
                          seeds: List[int]) -> List[Dict]:
        """One coalesced launch of a family method group, as JAX's:
        SCAN stacks to (k, n) with the implementation a cost-oracle
        decision (exec.select-audited), the scalar its last prefix; SEG*
        concatenates the k ragged payloads with renumbered segment ids
        into one segment reduce, the scalar the float64 sum of the
        non-empty segments; ARG* stacks to (k, n) for one row-wise
        (key, index) reduce. One LaunchPlan each, and a `family.serve`
        event."""
        from tpu_reductions_torch.exec import core as exec_core
        from tpu_reductions_torch.exec.cost import CostOracle, emit_select
        from tpu_reductions_torch.exec.plan import launch_plan
        from tpu_reductions_torch.obs import ledger
        from tpu_reductions_torch.ops import oracle as oracle_mod
        from tpu_reductions_torch.ops.family import (SEG_BASE,
                                                     arg_reduce_rows_fn,
                                                     host_segment_reduce,
                                                     random_offsets,
                                                     scan_rows_fn,
                                                     segment_ids_from_offsets,
                                                     segment_reduce_fn)

        fault_point("serve.batch")

        t0 = time.perf_counter()
        payloads = [_fill(n, dtype, s).reshape(-1) for s in seeds]
        t1 = time.perf_counter()
        k = len(payloads)
        host = oracle_mod.host_value
        marks = {}

        def on_card(build):
            """Copy `build()`'s host tensors and run the reduction."""
            def launch():
                self.launches[surface] += 1
                with self._on_card():
                    c0 = time.perf_counter()
                    args, fn = build()
                    # redlint: disable=RED015 -- a coalesced family batch: the batcher caps a stacked launch at the stager's threshold (serve/engine.py DEFAULT_MAX_REQUEST_BYTES, 512 MiB)
                    args = [a.to(self.device) for a in args]
                    # redlint: disable=RED018 -- the copy's host seconds are serving latency the client sees (per-step attribution), not a kernel time
                    self._sync()
                    c1 = time.perf_counter()
                    vals = fn(*args)
                    c2 = time.perf_counter()
                marks["copy"], marks["reduce"] = c1 - c0, c2 - c1
                return vals
            return launch

        if method == "SCAN":
            decision = CostOracle().pick_scan(dtype, n)
            emit_select(decision, method=method, dtype=dtype, n=n,
                        batch=k)
            fn = scan_rows_fn(decision.choice, dtype)
            stacked = torch.stack(payloads)
            surface = f"family-scan/{decision.choice}"
            launch = on_card(lambda: ([stacked],
                                      lambda x: host(fn(x)[:, -1])))
        elif method in SEG_BASE:
            s = self._SERVE_SEGMENTS
            offsets = [random_offsets(n, s, seed) for seed in seeds]
            flat = torch.cat(payloads)
            ids = torch.from_numpy(np.concatenate(
                [np.int32(i * s) + segment_ids_from_offsets(off)
                 for i, off in enumerate(offsets)]).astype(np.int64))
            # empty segments hold the identity (+-inf for float MIN/MAX),
            # which must not reach the digest: both sides drop them
            nonempty = np.stack([np.diff(off) > 0 for off in offsets])
            sfn = segment_reduce_fn(method, k * s)
            surface = f"family-seg/{method.lower()}"

            def digest(x, i):
                segs = host(sfn(x, i)).astype(np.float64).reshape(k, s)
                return np.where(nonempty, segs, 0.0).sum(axis=1)

            launch = on_card(lambda: ([flat, ids], digest))
        else:   # ARGMIN / ARGMAX
            fn = arg_reduce_rows_fn(method, dtype)
            stacked = torch.stack(payloads)
            surface = f"family-argk/{method.lower()}"
            launch = on_card(lambda: ([stacked], lambda x: host(fn(x))))
        t2 = time.perf_counter()

        plan = launch_plan(surface, "serve", lambda ctx: launch(),
                           timing="serve", heartbeat_phase="serve",
                           retry=True, drain=True, method=method,
                           dtype=dtype, n=n, batch=k)
        bucket_key = (surface, dtype, n, _bucket(k))
        if bucket_key not in _observed_buckets:
            _observed_buckets.add(bucket_key)
            with exec_core.observe_compile(plan.surface, dtype=dtype,
                                           n=n, batch=k):
                vals = exec_core.run(plan)
        else:
            vals = exec_core.run(plan)

        t3 = time.perf_counter()
        out: List[Dict] = []
        for i in range(k):
            x = payloads[i].numpy() if dtype != "bfloat16" else payloads[i]
            if method in SEG_BASE:
                segs_h = host_segment_reduce(x, offsets[i], method)
                # the digest is a SUM of segment results: SUM's tolerance
                # (exact for SEGMIN/SEGMAX and int32)
                out.append(_verified(vals[i],
                                     float(segs_h[nonempty[i]].sum()),
                                     method, dtype, n, verify_as="SUM"))
            else:
                out.append(_verified(vals[i],
                                     oracle_mod.host_reduce(x, method),
                                     method, dtype, n))
        t4 = time.perf_counter()
        self._account(fill=t1 - t0, stack=t2 - t1, copy=marks["copy"],
                      reduce=marks["reduce"], verify=t4 - t3)
        ok_count = sum(r["ok"] for r in out)
        ledger.emit("family.serve", method=method, dtype=dtype, n=n,
                    batch=k, surface=surface, ok=ok_count,
                    failed=k - ok_count)
        return out

    def run_stream(self, method: str, dtype: str, n: int, seed: int,
                   *, chunk_bytes: Optional[int] = None,
                   sync_every: int = 8) -> Dict:
        """One oversized request through the streaming pipeline
        (ops/stream.run_stream: bounded chunks, at most two on the card),
        verified by the incremental oracle over the same chunks."""
        from tpu_reductions_torch.config import DTYPE_ALIASES, FAMILY_METHODS
        from tpu_reductions_torch.exec import core as exec_core
        from tpu_reductions_torch.exec.plan import launch_plan
        from tpu_reductions_torch.ops import oracle as oracle_mod
        from tpu_reductions_torch.ops.stream import (iter_chunks,
                                                     plan_chunks,
                                                     run_stream)

        method = method.upper()
        dtype = DTYPE_ALIASES.get(dtype, dtype)
        if method in FAMILY_METHODS and method != "SCAN":
            raise ValueError(f"{method} has no streaming path; only "
                             "SCAN chunk-carries (ops/family/scan.py)")
        if method == "SCAN":
            return self._run_stream_scan(dtype, n, seed,
                                         chunk_bytes=chunk_bytes)

        fault_point("serve.batch")

        x = _fill(n, dtype, seed)
        surface = f"serve-stream/{method.lower()}"

        def launch():
            self.launches[surface] += 1
            with self._on_card():
                return run_stream(x, method, chunk_bytes=chunk_bytes,
                                  sync_every=sync_every,
                                  device=self.device)

        res = exec_core.run(launch_plan(
            surface, "serve", lambda ctx: launch(),
            timing="stream", heartbeat_phase="serve", retry=True,
            drain=True, method=method, dtype=dtype, n=n))

        oracle = oracle_mod.IncrementalOracle(method, dtype)
        for chunk in iter_chunks(x, plan_chunks(n, dtype, chunk_bytes)):
            oracle.update(chunk)
        return {**_verified(res.value, oracle.value(), method, dtype, n),
                "chunks": res.num_chunks, "gbps": round(res.gbps, 4)}

    def _run_stream_scan(self, dtype: str, n: int, seed: int, *,
                         chunk_bytes: Optional[int] = None) -> Dict:
        """An oversized SCAN through the chunk-carry scanner
        (ops/family/scan.StreamScanner), its scalar the final carry."""
        from tpu_reductions_torch.exec import core as exec_core
        from tpu_reductions_torch.exec.plan import launch_plan
        from tpu_reductions_torch.ops import oracle as oracle_mod
        from tpu_reductions_torch.ops.family.scan import StreamScanner
        from tpu_reductions_torch.ops.stream import iter_chunks, plan_chunks

        fault_point("serve.batch")

        x = _fill(n, dtype, seed).reshape(-1)
        sc = StreamScanner(dtype, n, chunk_bytes=chunk_bytes,
                           device=self.device)
        surface = "serve-stream/scan"

        def launch():
            self.launches[surface] += 1
            with self._on_card():
                return sc.scan(x)

        t0 = time.perf_counter()
        exec_core.run(launch_plan(
            surface, "serve", lambda ctx: ctx.call(launch, phase="serve"),
            timing="stream", heartbeat_phase=None, retry=False,
            drain=True, staging_bound=int(sc.plan.chunk_bytes),
            method="SCAN", dtype=dtype, n=n))
        wall = time.perf_counter() - t0

        oracle = oracle_mod.IncrementalOracle("SCAN", dtype)
        for chunk in iter_chunks(x, plan_chunks(n, dtype, chunk_bytes)):
            oracle.update(chunk)
        return {**_verified(sc.carry, oracle.value(), "SCAN", dtype, n),
                "chunks": sc.plan.num_chunks,
                "gbps": round(x.numel() * x.element_size()
                              / max(wall, 1e-9) / 1e9, 4)}

    def run_sharded(self, method: str, dtype: str, n: int, seed: int,
                    *, chunk_bytes: Optional[int] = None,
                    quantized: bool = False, quant_bits: int = 8,
                    devices: Optional[int] = None) -> Dict:
        """One oversized request over the rank axis (module docstring):
        K contiguous shards folded chunk by chunk into K resident
        (width*8, 128) partials, then one collective combine. With
        `quantized` the combine rides the block-scaled wire
        (collectives/quant.py) where the geometry carries it, and the
        check accepts its declared bound. `devices`, a rank count,
        overrides `ranks` (JAX's takes the devices themselves). Same
        response as run_batch, plus the selection and `devices`."""
        from tpu_reductions_torch.collectives.algorithms import \
            select_algorithm
        from tpu_reductions_torch.collectives.core import \
            make_collective_reduce
        from tpu_reductions_torch.collectives.quant import (
            make_quant_sum_all_reduce, quant_error_bound, quant_supported)
        from tpu_reductions_torch.config import DTYPE_ALIASES, FAMILY_METHODS
        from tpu_reductions_torch.exec import core as exec_core
        from tpu_reductions_torch.exec.plan import launch_plan
        from tpu_reductions_torch.obs import ledger, trace
        from tpu_reductions_torch.ops import oracle as oracle_mod
        from tpu_reductions_torch.ops.registry import (accum_dtype, get_op,
                                                       torch_dtype)
        from tpu_reductions_torch.ops.stream import (_BLOCK, _LANES,
                                                     _SUBLANES, dtype_name,
                                                     iter_chunks,
                                                     plan_chunks)
        from tpu_reductions_torch.parallel.mesh import build_mesh

        fault_point("serve.batch")

        method = method.upper()
        dtype = DTYPE_ALIASES.get(dtype, dtype)
        if method in FAMILY_METHODS:
            if method == "SCAN":
                # an oversized SCAN chunk-carries; its digest is the same
                # scalar
                return self.run_stream(method, dtype, n, seed,
                                       chunk_bytes=chunk_bytes)
            raise ValueError(f"{method} has no device-parallel path; "
                             "family methods serve via the coalesced "
                             "batch (docs/FAMILY.md)")
        if dtype == "float64":
            raise ValueError("float64 shards through the dd stream "
                             "path, not run_sharded (serve/engine.py "
                             "_should_shard)")
        k = min(self.ranks if devices is None else int(devices), n)
        if k <= 1:
            # one rank: the streaming path is the sharded path
            return self.run_stream(method, dtype, n, seed,
                                   chunk_bytes=chunk_bytes)

        t0 = time.perf_counter()
        x = _fill(n, dtype, seed).reshape(-1)
        t1 = time.perf_counter()
        op = get_op(method)
        acc_dt = accum_dtype(torch_dtype(dtype)) if method == "SUM" \
            else torch_dtype(dtype)
        base = -(-n // k)                       # a shard's length
        plan = plan_chunks(base, dtype, chunk_bytes)
        # 16 blocks wide where the chunk allows: a per-rank length that
        # divides by k * QUANT_BLOCK at k = 8, so the quantized ring
        # applies to the combine, as in JAX
        width = min(16, plan.chunk_elems // _BLOCK)
        per_rank = width * _BLOCK
        dev = self.device
        pad_value = op.identity(x.dtype)
        surface = f"serve-shard/{method.lower()}"

        def fold_shard(rank: int) -> torch.Tensor:
            # shard `rank`, one bounded copy a chunk, folded into its
            # partial; a ragged chunk pads to whole fold blocks with the
            # identity
            shard = x[rank * base:min(n, (rank + 1) * base)]
            with self._on_card():
                acc = torch.full((width * _SUBLANES, _LANES),
                                 op.identity(acc_dt), dtype=acc_dt,
                                 device=dev)
                for c in range(-(-shard.numel() // plan.chunk_elems)):
                    piece = shard[c * plan.chunk_elems:
                                  (c + 1) * plan.chunk_elems]
                    pad = -piece.numel() % per_rank
                    if pad:
                        piece = torch.cat([piece, piece.new_full(
                            (pad,), pad_value)])
                    # redlint: disable=RED015 -- one plan_chunks chunk, at most config.stage_chunk_bytes
                    staged = piece.to(dev).view(-1, width * _SUBLANES,
                                                _LANES)
                    acc = op.combine(acc,
                                     op.reduce_dim(staged, 0).to(acc_dt))
                # redlint: disable=RED018 -- the shard fold's host seconds are serving latency the client sees, not a kernel time
                self._sync()
            return acc

        def launch(ctx):
            # the k partials: rows of one tensor on the device
            self.launches[surface] += 1
            parts = [ctx.call(lambda r=r: fold_shard(r), phase="serve")
                     for r in range(k)]
            with self._on_card():
                return torch.stack(parts).view(k, per_rank)

        rows = exec_core.run(launch_plan(
            surface, "serve", launch, timing="serve",
            heartbeat_phase=None, drain=True,
            staging_bound=int(plan.chunk_bytes), method=method,
            dtype=dtype, n=n, devices=k))
        t2 = time.perf_counter()

        # the combine's dtype is what the partials hold (bfloat16 SUM
        # accumulates in float32)
        combine_dtype = dtype_name(acc_dt)
        use_quant = bool(quantized) and method == "SUM" \
            and quant_supported(method, combine_dtype, quant_bits)
        selection = select_algorithm(method, combine_dtype, k, per_rank,
                                     quantized=use_quant,
                                     bits=quant_bits)
        ledger.emit("collective.select", algorithm=selection.algorithm,
                    method=method, dtype=combine_dtype, ranks=k,
                    wire_factor=round(selection.wire_factor, 6),
                    quantized=use_quant,
                    bits=(quant_bits if use_quant else None))
        mesh = build_mesh(num_devices=k, platform=self.platform,
                          local_ranks=k, device=dev)
        coll = (make_quant_sum_all_reduce(mesh, bits=quant_bits,
                                          dtype=combine_dtype)
                if use_quant else
                make_collective_reduce(method, mesh, rooted="none"))

        def combine():
            with self._on_card():
                # numpy has no bfloat16: a bfloat16 MIN/MAX block crosses
                # as float32, which holds its values exactly
                return oracle_mod.host_value(coll(rows)[0])

        with trace.child():
            ledger.emit("collective.launch",
                        algorithm=selection.algorithm, method=method,
                        dtype=combine_dtype, ranks=k, n=int(per_rank))
            c0 = time.perf_counter()
            block = exec_core.run(launch_plan(
                f"serve-combine/{selection.algorithm}", "collective",
                lambda ctx: ctx.call(combine, phase="serve"),
                timing="serve", heartbeat_phase=None, drain=True,
                method=method, dtype=combine_dtype, ranks=k,
                quantized=use_quant))
            ledger.emit("collective.done",
                        algorithm=selection.algorithm, method=method,
                        dtype=combine_dtype, ranks=k,
                        wall_s=round(time.perf_counter() - c0, 6),
                        rows=1)
        t3 = time.perf_counter()

        # host collapse of the replicated block, as StreamReducer.finish
        # does (int32 SUM wraps modulo 2^32)
        if method == "SUM" and block.dtype == np.int32:
            value = np.int64(block.sum(dtype=np.int64)
                             ).astype(np.int32)[()]
        elif method == "SUM":
            value = np.float64(block.astype(np.float64).sum())
        else:
            value = op.np_reduce(block)

        oracle = oracle_mod.IncrementalOracle(method, dtype)
        for chunk in iter_chunks(x, plan_chunks(n, dtype, chunk_bytes)):
            oracle.update(chunk)
        out = _verified(value, oracle.value(), method, dtype, n)
        bound = None
        if not out["ok"] and use_quant:
            # the quantized wire is approximate by contract: the declared
            # per-element bound summed over the combined block
            with self._on_card():
                max_abs = float(rows.double().abs().max())
            bound = quant_error_bound(method, combine_dtype, quant_bits,
                                      k, max_abs) * per_rank
            out["ok"] = out["diff"] <= bound
        t4 = time.perf_counter()
        self.last_shard = {"fill": t1 - t0, "fold": t2 - t1,
                           "combine": t3 - t2, "verify": t4 - t3}
        return {**out,
                "algorithm": selection.algorithm,
                "wire_factor": round(selection.wire_factor, 6),
                "quantized": use_quant,
                "quant_bound": bound,
                "devices": k,
                "note": f"the {k} ranks are rows of one tensor on "
                        f"{dev.type}",
                "per_device_chunks": plan.num_chunks,
                "chunk_bytes": plan.chunk_bytes}

    def run_reshard(self, plan, carried: np.ndarray) -> Dict:
        """Run one planner program (reshard/planner.plan_reshard) on a
        rank mesh of this executor's device: the drain's device seam
        (serve/autoscale.drain_replica). Returns execute_plan's dict
        ({'shards', 'wall_s', 'steps', 'measured_mem_factor',
        'device_mem_factor'})."""
        from tpu_reductions_torch.exec import core as exec_core
        from tpu_reductions_torch.exec.plan import launch_plan
        from tpu_reductions_torch.reshard.primitives import (execute_plan,
                                                             make_mesh)

        fault_point("serve.batch")

        def launch(ctx):
            with self._on_card():
                mesh = make_mesh(plan.source.num_ranks, self.platform)
                return execute_plan(plan, carried, mesh)

        return exec_core.run(launch_plan(
            "serve-reshard", "reshard", launch,
            timing="steps", heartbeat_phase="serve", retry=True,
            drain=True, ranks=plan.source.num_ranks,
            steps=len(plan.steps)))
