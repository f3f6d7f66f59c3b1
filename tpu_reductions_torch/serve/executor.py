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

`run_sharded` and `run_reshard` belong to the replica fleet (ROADMAP
Queue A item 8b); one engine on one card never calls them
(`capabilities()["device_count"]` is 1).
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

    def __init__(self, platform: str = "gpu") -> None:
        self.platform = platform
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
        float64 natively and so does the CPU; one engine serves one
        device, so the shard route never applies."""
        if self._caps is None:
            self._caps = {"backend": self.device.type,
                          "supports_f64": True,
                          "device_count": 1}
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
                    x = stacked.to(self.device)
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
                    args = [a.to(self.device) for a in args]
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

    def run_sharded(self, *args, **kwargs) -> Dict:
        """Device-parallel oversized requests: ROADMAP Queue A item 8b."""
        raise NotImplementedError(
            "run_sharded belongs to the replica fleet (ROADMAP Queue A "
            "item 8b); one engine on one card streams oversized requests")

    def run_reshard(self, *args, **kwargs) -> Dict:
        """A drain's partial reshard: ROADMAP Queue A item 8b."""
        raise NotImplementedError(
            "run_reshard belongs to the replica fleet's drain (ROADMAP "
            "Queue A item 8b)")
