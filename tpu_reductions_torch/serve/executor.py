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

The shard route (docs/PORT.md "The shard route across cards") and the
drain's reshard: `BatchExecutor(ranks=K)` reports `device_count: K`, and
the engine then sends a request over the shard threshold to
`run_sharded`, which splits the payload into K contiguous shards and
places them on the executor's cards (`cards`, by default every card of
the host, device.cards) in contiguous, rank-ordered blocks
(device.rank_blocks). One host thread a card folds its ranks' shards on
that card, chunk by chunk (every host-to-device copy bounded by
ops/stream.plan_chunks), into (width*8, 128) partials; the K partials
are then copied onto the executor's own card in rank order, the rows of
one (K, width*8*128) tensor, and combined there with the collective that
collectives/algorithms.select_algorithm names (`collective.select`,
`collective.launch` and `collective.done` events): the JAX package's
per-device folds and XLA collective over a device mesh. With one card
the K ranks are rows of one tensor on it, as the collective driver's
are. The fold is one torch reduction over a chunk's blocks, as JAX's
`_jit_shard_fold` is jnp under jit; no kernel of the repository runs
here. `last_shard` keeps the seconds of the last sharded request's
fill, fold (and each card's), gather, combine and verify. `run_reshard`
runs a planner program (reshard/primitives.execute_plan), the drain's
device seam, on the same placement: k ranks on min(k, C) of the cards in
blocks, one host thread a card joined by a peer group (parallel/peer.py;
docs/PORT.md "The drain across cards"), or the rows of one tensor on one
card.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

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


def _shard_note(k: int, blocks: List[range], lead: torch.device) -> str:
    """The shard route's placement in words: with one card, the ranks as
    rows of one tensor; with more, the split and where the partials
    meet."""
    if len(blocks) == 1:
        return f"the {k} ranks are rows of one tensor on {lead.type}"
    sizes = sorted({len(b) for b in blocks})
    each = "-".join(str(s) for s in sizes)
    return (f"{k} ranks on {len(blocks)} cards ({each} a card), each card "
            f"folding its ranks' shards; the {k} partials gathered onto "
            f"{lead} for the combine")


def _gather_route(card: torch.device, lead: torch.device) -> str:
    """How a card's partials reach the lead card: `local` (the same
    device), `peer` (a direct peer copy) or `host` (the driver stages a
    copy between cards without peer access through host memory)."""
    if card == lead or card.type != "cuda" or lead.type != "cuda":
        return "local"
    return ("peer" if torch.cuda.can_device_access_peer(lead, card)
            else "host")


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
    one touches no device. `cards`, the devices the shard route folds
    on (JAX's `devices=`), defaults to every card of the host
    (device.cards); the executor's own card (`device`) leads."""

    def __init__(self, platform: str = "gpu", ranks: int = 1,
                 cards: Optional[Sequence[torch.device]] = None) -> None:
        if ranks < 1:
            raise ValueError(f"ranks must be >= 1, got {ranks}")
        if cards is not None and not cards:
            raise ValueError("cards must name at least one device")
        self.platform = platform
        self.ranks = int(ranks)
        self._cards = (None if cards is None
                       else [torch.device(c) for c in cards])
        # seconds of the last sharded request's steps; `fold_cards` a list
        self.last_shard: Optional[Dict] = None
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

    @property
    def cards(self) -> List[torch.device]:
        """The shard route's devices: the constructor's, else every card
        of the host (a query; each card's context is made by its first
        sharded request)."""
        if self._cards is None:
            from tpu_reductions_torch import device as device_mod
            self._cards = device_mod.cards(self.platform)
        return self._cards

    def capabilities(self) -> dict:
        """{'backend', 'supports_f64', 'device_count', 'cards'}: the card
        adds float64 natively and so does the CPU; `device_count` is the
        ranks of the shard route (the engine shards only above 1),
        `cards` the devices its folds spread over."""
        if self._caps is None:
            self._caps = {"backend": self.device.type,
                          "supports_f64": True,
                          "device_count": self.ranks,
                          "cards": len(self.cards)}
        return self._caps

    @contextlib.contextmanager
    def _on_card(self, card: Optional[torch.device] = None):
        """The calling thread's device set to `card` (the executor's own
        by default), its work on that card's default stream (a no-op on
        the CPU)."""
        dev = self.device if card is None else card
        if dev.type != "cuda":
            yield
            return
        torch.cuda.set_device(dev)
        with torch.cuda.stream(torch.cuda.default_stream(dev)):
            yield

    def _sync(self, card: Optional[torch.device] = None) -> None:
        """Wait for `card`'s queued work (the executor's own card by
        default)."""
        from tpu_reductions_torch import device as device_mod
        device_mod.synchronize(self.device if card is None else card)

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
        K contiguous shards, placed on the cards in rank-ordered blocks,
        each card folding its shards chunk by chunk into resident
        (width*8, 128) partials in a host thread of its own; the K
        partials gathered onto the executor's card in rank order, then
        one collective combine there. With `quantized` the combine rides
        the block-scaled wire (collectives/quant.py) where the geometry
        carries it, and the check accepts its declared bound. `devices`,
        a rank count, overrides `ranks` (JAX's takes the devices
        themselves). A failure on any card fails the request. Same
        response as run_batch, plus the selection, `devices`, `cards`,
        each partial's device before the gather (`partials_on`), the
        chunks each card folded (`card_chunks`) and how each card's
        partials reached the lead (`gather_route`: local, peer or
        host)."""
        from tpu_reductions_torch import device as device_mod
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
        blocks = device_mod.rank_blocks(k, len(self.cards))
        cards = self.cards[:len(blocks)]
        pad_value = op.identity(x.dtype)
        surface = f"serve-shard/{method.lower()}"
        parts: List[Optional[torch.Tensor]] = [None] * k
        card_chunks = [0] * len(cards)
        card_s = [0.0] * len(cards)

        def fold_shard(rank: int, c: int) -> torch.Tensor:
            # shard `rank`, one bounded copy a chunk, folded into its
            # partial on card c; a ragged chunk pads to whole fold blocks
            # with the identity
            card_device = cards[c]
            shard = x[rank * base:min(n, (rank + 1) * base)]
            with self._on_card(card_device):
                acc = torch.full((width * _SUBLANES, _LANES),
                                 op.identity(acc_dt), dtype=acc_dt,
                                 device=card_device)
                for i in range(-(-shard.numel() // plan.chunk_elems)):
                    piece = shard[i * plan.chunk_elems:
                                  (i + 1) * plan.chunk_elems]
                    pad = -piece.numel() % per_rank
                    if pad:
                        piece = torch.cat([piece, piece.new_full(
                            (pad,), pad_value)])
                    # redlint: disable=RED015 -- one plan_chunks chunk, at most config.stage_chunk_bytes
                    staged = piece.to(card_device).view(
                        -1, width * _SUBLANES, _LANES)
                    acc = op.combine(acc,
                                     op.reduce_dim(staged, 0).to(acc_dt))
                    card_chunks[c] += 1
                # the shard's work done on its card before its ctx.call
                # returns: the heartbeat guard covers a stuck card
                # redlint: disable=RED018 -- the shard fold's host seconds are serving latency the client sees, not a kernel time
                self._sync(card_device)
            return acc

        def fold_card(ctx, c: int) -> None:
            # card c's ranks, one ctx.call a shard, in this card's thread
            f0 = time.perf_counter()
            for r in blocks[c]:
                parts[r] = ctx.call(lambda r=r: fold_shard(r, c),
                                    phase="serve")
            card_s[c] = time.perf_counter() - f0

        marks = {}

        def launch(ctx):
            self.launches[surface] += 1
            # one host thread a card, so that no card's waits hold back
            # another card's copies; every card's folds done (and
            # synchronised) before the gather
            with ThreadPoolExecutor(len(cards)) as pool:
                futures = [pool.submit(contextvars.copy_context().run,
                                       fold_card, ctx, c)
                           for c in range(len(cards))]
            for fut in futures:
                fut.result()
            marks["partials_on"] = [str(p.device) for p in parts]
            g0 = time.perf_counter()
            with self._on_card():
                # the gather: K copies onto the lead card, in rank order
                rows = torch.empty((k, per_rank), dtype=acc_dt, device=dev)
                for r, p in enumerate(parts):
                    rows[r].copy_(p.view(-1))
                self._sync()
            marks["gather"] = time.perf_counter() - g0
            return rows

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
        self.last_shard = {"fill": t1 - t0,
                           "fold": t2 - t1 - marks["gather"],
                           "fold_cards": card_s, "gather": marks["gather"],
                           "combine": t3 - t2, "verify": t4 - t3}
        return {**out,
                "algorithm": selection.algorithm,
                "wire_factor": round(selection.wire_factor, 6),
                "quantized": use_quant,
                "quant_bound": bound,
                "devices": k,
                "cards": len(cards),
                "note": _shard_note(k, blocks, dev),
                "per_device_chunks": plan.num_chunks,
                "chunk_bytes": plan.chunk_bytes,
                "partials_on": marks["partials_on"],
                "card_chunks": card_chunks,
                "gather_route": [_gather_route(card, dev)
                                 for card in cards]}

    def run_reshard(self, plan, carried: np.ndarray) -> Dict:
        """Run one planner program (reshard/planner.plan_reshard) on a
        rank mesh of this executor's cards: the drain's device seam
        (serve/autoscale.drain_replica; JAX's run_reshard over make_mesh,
        tpu_reductions/serve/executor.py:666-687). With more than one
        card and at least 2 ranks, the k ranks lie on C' = min(k, C) of
        `cards` in rank-ordered blocks (device.rank_blocks), each card's
        rows on that card, and the program runs in one host thread a card
        on parallel/mesh.peer_meshes (parallel/peer.py: the hops are
        copies between the cards); else the ranks are rows of one tensor
        on this executor's device. A failure on any card aborts the
        others' rendezvous, and the run raises that failure. Returns
        execute_plan's dict ({'shards', 'wall_s', 'steps',
        'measured_mem_factor', 'device_mem_factor'}; card 0's timings, the
        largest card's peak) plus `cards`, C', and `copy_route`: for each
        pair of cards "a-b", `peer` where each has peer access to the
        other, else `host` (`local` on the CPU)."""
        from tpu_reductions_torch import device as device_mod
        from tpu_reductions_torch.exec import core as exec_core
        from tpu_reductions_torch.exec.plan import launch_plan
        from tpu_reductions_torch.parallel.mesh import peer_meshes
        from tpu_reductions_torch.parallel.peer import first_failure
        from tpu_reductions_torch.reshard.primitives import (execute_plan,
                                                             make_mesh)

        fault_point("serve.batch")
        k = plan.source.num_ranks
        cards = self.cards[:len(device_mod.rank_blocks(k, len(self.cards)))]

        def twin(ctx):
            with self._on_card():
                mesh = make_mesh(k, self.platform)
                return execute_plan(plan, carried, mesh)

        def across(ctx):
            meshes = peer_meshes(k, cards)
            results: List[Optional[Dict]] = [None] * len(cards)

            def on_card(c: int) -> None:
                try:
                    with self._on_card(cards[c]):
                        results[c] = execute_plan(plan, carried, meshes[c])
                except BaseException:
                    meshes[c].group.abort()
                    raise

            # one host thread a card: a card's rendezvous waits hold back
            # no other card's work
            with ThreadPoolExecutor(len(cards)) as pool:
                futures = [pool.submit(contextvars.copy_context().run,
                                       on_card, c)
                           for c in range(len(cards))]
            error = first_failure([f.exception() for f in futures])
            if error is not None:
                raise error
            return results[0]

        res = exec_core.run(launch_plan(
            "serve-reshard", "reshard", across if len(cards) > 1 else twin,
            timing="steps", heartbeat_phase="serve", retry=True,
            drain=True, ranks=k, steps=len(plan.steps)))
        return {**res, "cards": len(cards),
                "copy_route": {f"{a}-{b}": _copy_route(cards[a], cards[b])
                               for a in range(len(cards))
                               for b in range(a + 1, len(cards))}}


def _copy_route(a: torch.device, b: torch.device) -> str:
    """How the drain's hops between two cards travel (run_reshard):
    `peer` where each card has peer access to the other, `host` where CUDA
    stages a copy through host memory, `local` on one device."""
    there, back = _gather_route(a, b), _gather_route(b, a)
    return "host" if "host" in (there, back) else there
