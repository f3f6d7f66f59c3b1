"""The serving core: admission -> queue -> coalesce -> plan -> launch ->
verify -> respond.

The counterpart of tpu_reductions/serve/engine.py, whole: one
`ServeEngine` is a persistent multi-tenant service over one device.

  * Admission control. `submit` resolves at once with `rejected` when a
    request is unservable (queue full, tenant over quota, unknown SLO
    class, oversized with streaming off, engine stopped or draining); an
    admitted request will resolve (every path ends in one terminal
    response). A full queue admits a higher-priority arrival by shedding
    the newest request of the lowest class below it; a class whose
    rolling p99 already passes its deadline is shed at admission.
  * Coalescing. Each round groups the queue by (method, dtype, n) into
    stacked launches (serve/coalesce.py), ranked by the knapsack against
    `device_window_s`; deferred batches go back ahead of new arrivals.
    An oversized request takes the streaming route alone.
  * Deadlines are checked at gather, before launch and at response: a
    late result is `expired`.
  * Shedding, not wedging: a dead transport fails the batch and sheds
    the queue; `stop(drain=True)` finishes the batch in flight and sheds
    the rest.
  * Exactly once: settled responses are cached by idempotency key
    (config.dedup_cache_size entries, LRU).
  * Every transition is a `serve.*` ledger event, stamped with the
    request's own trace (obs/trace.request_fields).

The engine makes no device call: all device work goes through
serve/executor.py, built lazily, from the worker thread (and from
`prewarm`). No lock of the engine is held around an executor call. The
transport gate defaults to `NullTransport` (a local card has no relay);
the shard route (`_launch_sharded`) is taken when the executor reports
more than one rank (BatchExecutor(ranks=K), serve --devices K).
"""


from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from tpu_reductions_torch import config
from tpu_reductions_torch.obs import ledger, trace
from tpu_reductions_torch.serve.coalesce import (Batch, CostModel, coalesce,
                                                 plan_round)
from tpu_reductions_torch.serve.request import (PendingResponse,
                                                ReduceRequest,
                                                ReduceResponse,
                                                TransportDead)
from tpu_reductions_torch.serve.transport import NullTransport

# per-request payload cap, and the batcher's byte cap of a stacked
# launch: utils/staging.py's chunking threshold, 512 MiB
DEFAULT_MAX_REQUEST_BYTES = 512 << 20

# dtypes the quantized collective wire carries for SUM (the shard
# route's wire; collectives/quant.py)
_QUANT_SUM_DTYPES = ("float32", "bfloat16")


class _SLOTracker:
    """Rolling per-SLO-class p99 over recent ok latencies. Nearest-rank
    p99 over a bounded window (newest 64): the admission-time signal
    for p99-aware shedding — when a class's observed tail already
    misses its deadline, admitting more of that class just converts
    future `ok`s into `expired`s after the device did the work."""

    def __init__(self, window: int = 64, min_samples: int = 8) -> None:
        self._window = window
        self.min_samples = min_samples
        self._samples: Dict[str, Deque[float]] = {}
        self._lock = threading.Lock()

    def observe(self, slo: str, latency_s: float) -> None:
        with self._lock:
            dq = self._samples.get(slo)
            if dq is None:
                dq = self._samples[slo] = deque(maxlen=self._window)
            dq.append(latency_s)

    def p99(self, slo: str) -> Optional[float]:
        """Nearest-rank p99 of the class window, or None below
        min_samples (a cold class is never shed on tail evidence it
        does not have)."""
        with self._lock:
            dq = self._samples.get(slo)
            if dq is None or len(dq) < self.min_samples:
                return None
            vals = sorted(dq)
        rank = max(0, -(-99 * len(vals) // 100) - 1)
        return vals[rank]


@dataclass
class _Admitted:
    """Engine-internal record of one admitted request."""

    request: ReduceRequest
    request_id: str
    pending: PendingResponse
    t_enqueue: float                     # monotonic
    t_deadline: Optional[float]          # monotonic absolute, or None
    t_launch: Optional[float] = None
    batch_size: Optional[int] = None
    streamed: bool = False               # oversized: routed through the
    #                                      streaming pipeline, never
    #                                      coalesced (ops/stream.py)

    def expired(self, now: float) -> bool:
        return self.t_deadline is not None and now > self.t_deadline

    @property
    def priority(self) -> int:
        return self.request.priority


class ServeEngine:
    """The multi-tenant serving engine (module docstring)."""

    def __init__(self, *, max_queue: int = 64, max_batch: int = 32,
                 coalesce_window_s: float = 0.005,
                 device_window_s: float = 0.25,
                 max_request_bytes: int = DEFAULT_MAX_REQUEST_BYTES,
                 stream_oversized: bool = True,
                 stream_chunk_bytes: Optional[int] = None,
                 shard_oversized: bool = True,
                 shard_threshold_bytes: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 slo_classes: Optional[Dict[str, float]] = None,
                 slo_min_samples: int = 8,
                 quant_slack_factor: float = 2.0,
                 dedup_cache_size: Optional[int] = None,
                 executor=None, transport=None,
                 cost_model: Optional[CostModel] = None,
                 platform: str = "gpu") -> None:
        if max_queue <= 0 or max_batch <= 0:
            raise ValueError("max_queue/max_batch must be positive")
        if tenant_quota is not None and tenant_quota <= 0:
            raise ValueError("tenant_quota must be positive (or None)")
        self._max_queue = max_queue
        self._max_batch = max_batch
        self._coalesce_window_s = coalesce_window_s
        self._device_window_s = device_window_s
        self._max_request_bytes = max_request_bytes
        # oversized requests used to be REJECTED at the byte cap (the
        # cap exists because one coalesced launch must never rebuild
        # the 4 GiB single-message relay killer); the streaming
        # pipeline serves them instead in O(2 chunks) of device memory
        # with every message bounded (ops/stream.py)
        self._stream_oversized = stream_oversized
        self._stream_chunk_bytes = stream_chunk_bytes
        # ...and above the shard threshold they go device-PARALLEL when
        # the backend has >1 device: staging-bounded per-device chunk
        # folds finished by a collective combine picked through
        # collectives/algorithms.select_algorithm (executor.run_sharded,
        # over the executor's ranks). f64 stays on the stream/dd
        # path — the collective registry's dd planes are a different
        # launch shape than the per-device fold accumulators.
        self._shard_oversized = shard_oversized
        self._shard_threshold = config.shard_threshold_bytes(
            shard_threshold_bytes)
        # multi-tenancy: per-tenant queued-depth quota, priority
        # preemption on a full queue, SLO classes (name -> deadline_s
        # applied when the request names no deadline of its own) with
        # p99-aware admission shedding
        self._tenant_quota = tenant_quota
        self._slo_classes = dict(slo_classes or {})
        self._slo = _SLOTracker(min_samples=slo_min_samples)
        self._quant_slack_factor = quant_slack_factor
        self._executor = executor          # lazy BatchExecutor when None
        self._platform = platform          # the lazy executor's device
        self._transport = transport if transport is not None \
            else NullTransport()
        self._cost_model = cost_model or CostModel()
        self._queue: Deque[_Admitted] = deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._stopped = False
        self._draining = False
        self._ids = itertools.count()
        # stats counters are bumped from submitter threads (admission)
        # AND the worker loop; every write funnels through _bump under
        # this lock. _exec_lock serializes the lazy BatchExecutor
        # construction for the same reason — construction touches no
        # device (serve/executor.py), so holding the lock never wraps a
        # device call.
        self._stats_lock = threading.Lock()
        self._exec_lock = threading.Lock()
        self.stats: Dict[str, float] = {
            "submitted": 0, "ok": 0, "error": 0, "rejected": 0,
            "expired": 0, "shed": 0, "batches": 0, "batched_requests": 0,
            "preempted": 0, "sharded": 0, "dedup_hits": 0}
        # exactly-once settlement: bounded LRU of settled terminal responses
        # keyed on the client-supplied idempotency key. A duplicate of
        # a settled key — a router re-route after a timeout, a client
        # retry across a controller crash — returns the cached response
        # WITHOUT re-touching the device. Only settled outcomes cache
        # (ok, and errors that are not transport/lifecycle failures);
        # rejected/shed/expired stay retryable by design. Eviction at
        # the bound degrades the evicted key to at-least-once (retry
        # re-executes) — documented fallback, never a hang.
        self._dedup_max = config.dedup_cache_size(dedup_cache_size)
        self._dedup: "OrderedDict[str, ReduceResponse]" = OrderedDict()
        self._dedup_lock = threading.Lock()
        # jit-bucket keys this engine has warmed or launched — the warm
        # state a planned drain hands to the surviving replicas
        # (serve/autoscale.drain_replica)
        self._warm_keys: set = set()

    def _bump(self, key: str, delta: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + delta

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "ServeEngine":
        """Start the worker; requests submitted before start() queue up
        and are served once it runs (the test seam for deterministic
        coalescing)."""
        if self._thread is not None:
            return self
        ledger.emit("serve.start", max_queue=self._max_queue,
                    max_batch=self._max_batch,
                    coalesce_window_s=self._coalesce_window_s,
                    device_window_s=self._device_window_s)
        self._thread = threading.Thread(target=self._run,
                                        name="serve-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Shut down: with drain, the worker finishes the batch in
        flight and sheds everything still queued with explicit `shed`
        responses; without, shedding happens immediately. Idempotent."""
        with self._cond:
            if self._stopped and self._thread is None:
                return
            self._stopping = True
            if not drain:
                self._shed_locked("engine-stopped")
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        with self._cond:
            self._shed_locked("engine-stopped")
            self._stopped = True
        ledger.emit("serve.stop", **{k: int(v)
                                     for k, v in self.stats.items()})

    def begin_drain(self) -> None:
        """Enter the draining admission mode (the fleet's drain): every NEW submit resolves `rejected` with the
        `replica-draining` mark — which the router re-routes for free
        (serve/router.replica_draining) — while queued and in-flight
        work keeps serving to completion. Distinct from stop(): the
        worker stays up, nothing sheds. The drain protocol
        (serve/autoscale.drain_replica) calls stop() only once the
        queue and the router's outstanding count hit zero, so a
        planned drain sheds ZERO requests where a kill sheds the
        queue."""
        with self._cond:
            self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def queued_depth(self) -> int:
        """Current admission-queue depth — one of the autoscaler's
        control signals (serve/autoscale.py) and the drain protocol's
        emptiness probe."""
        with self._cond:
            return len(self._queue)

    def slo_p99(self, slo: str) -> Optional[float]:
        """Rolling p99 of an SLO class (the _SLOTracker the p99-aware
        shed consults), exported as an autoscaler control signal."""
        return self._slo.p99(slo)

    def warm_bucket_keys(self) -> List[tuple]:
        """The (method, dtype, n) jit-bucket keys this engine has
        warmed or served — the cache state a planned drain prewarms
        onto survivors so retiring the replica does not re-cold-start
        its traffic (serve/autoscale.drain_replica)."""
        with self._stats_lock:
            return sorted(self._warm_keys)

    def prewarm(self, method: str, dtype: str, n: int,
                up_to_batch: int = 1) -> None:
        """Warm a key through the executor: one launch per bucket (1, 2,
        4, ... up_to_batch), so that serving traffic pays no first-call
        cost (library load, allocator growth, the seam's span) inside a
        measured or deadline-bound window. Call before start() or while
        the engine is idle."""
        dtype = config.DTYPE_ALIASES.get(dtype, dtype)
        with self._stats_lock:
            self._warm_keys.add((method, dtype, n))
        k = 1
        while True:
            self._ensure_executor().run_batch(method, dtype, n,
                                              list(range(k)))
            if k >= up_to_batch:
                return
            k <<= 1

    # -- admission ----------------------------------------------------

    def submit(self, request: ReduceRequest) -> PendingResponse:
        """Admit, reject, or shed one request; always returns a
        PendingResponse (rejections and admission-time sheds come back
        already resolved). Admission order: static servability ->
        SLO-class resolution -> p99-aware shed -> tenant quota ->
        queue bound (with priority preemption)."""
        rid = f"r{next(self._ids):06d}"
        pending = PendingResponse(rid)
        self._bump("submitted")
        # exactly-once short-circuit BEFORE admission: a settled
        # idempotency key answers from the dedup cache even on a
        # draining or stopping engine — the work already happened;
        # re-running it (or bouncing the retry) would break the
        # one-terminal-status-per-key contract
        if request.idem_key is not None:
            cached = self._dedup_get(request.idem_key)
            if cached is not None:
                self._bump("dedup_hits")
                ledger.emit("serve.dedup", req=rid,
                            idem=request.idem_key,
                            orig=cached.request_id,
                            status=cached.status,
                            **trace.request_fields(rid))
                pending.resolve(cached)
                return pending
        reason = self._admission_reason(request)
        if reason is not None:
            return self._resolve_at_admission(request, rid, pending,
                                              "rejected", reason)
        deadline_s = self._effective_deadline(request)
        # p99-aware shedding: when the
        # class's observed tail already blows its deadline, the honest
        # terminal status is `shed` (load), not `rejected` (malformed/
        # unservable) — the device work the request would trigger is
        # predicted to expire anyway
        if request.slo is not None and deadline_s is not None:
            p99 = self._slo.p99(request.slo)
            if p99 is not None and p99 > deadline_s:
                return self._resolve_at_admission(
                    request, rid, pending, "shed",
                    f"p99-over-slo: class {request.slo!r} p99 "
                    f"{p99:.3f}s > deadline {deadline_s:.3f}s")
        now = time.monotonic()
        adm = _Admitted(request=request, request_id=rid, pending=pending,
                        t_enqueue=now,
                        t_deadline=(now + deadline_s
                                    if deadline_s else None),
                        streamed=(request.nbytes
                                  > self._max_request_bytes
                                  # above the shard threshold the
                                  # request leaves the coalesced path
                                  # even when it fits the byte cap:
                                  # the stream fork then picks
                                  # device-parallel vs chunked-serial
                                  # (_should_shard)
                                  or (self._shard_oversized
                                      and request.dtype != "float64"
                                      and request.nbytes
                                      > self._shard_threshold)))
        with self._cond:
            reason = self._enqueue_locked(adm)
            depth = len(self._queue)
            if reason is None:
                self._cond.notify_all()
        if reason is not None:
            return self._resolve_at_admission(request, rid, pending,
                                              "rejected", reason)
        # one trace per request: the request id IS the
        # trace id, so every event of its lifecycle shares identity
        # and trace_export renders one lane per request
        ledger.emit("serve.enqueue", req=rid, method=request.method,
                    dtype=request.dtype, n=request.n, depth=depth,
                    streamed=adm.streamed, tenant=request.tenant,
                    priority=request.priority,
                    # the idem key on the enqueue row is what makes
                    # "zero duplicate device executions" LEDGER-
                    # verifiable: loadgen --recovery joins enqueue
                    # rows to coalesce/launch rows per key
                    **({"idem": request.idem_key}
                       if request.idem_key else {}),
                    **trace.request_fields(rid))
        return pending

    # -- exactly-once dedup cache -------------------------------------

    def _dedup_get(self,
                   idem_key: str) -> Optional[ReduceResponse]:
        """Cached terminal response for a settled key (LRU touch), or
        None — the miss path costs one dict lookup under a lock."""
        with self._dedup_lock:
            resp = self._dedup.get(idem_key)
            if resp is not None:
                self._dedup.move_to_end(idem_key)
            return resp

    @staticmethod
    def _dedup_settled(status: str, error: Optional[str]) -> bool:
        """Whether an outcome is a SETTLEMENT worth caching. ok always
        is; an error is only when the device genuinely executed and
        failed (verification mismatch, contained batch crash) — a
        transport/lifecycle failure (dead relay, stopping engine,
        draining replica) must stay retryable, or a cached failure
        would poison every later retry of the key."""
        if status == "ok":
            return True
        if status != "error":
            return False
        e = error or ""
        return not any(mark in e for mark in (
            "relay dead", "relay-dead", "engine-stopped",
            "replica-draining"))

    def _dedup_put(self, idem_key: str, resp: ReduceResponse) -> None:
        """Record a settlement (first settle wins — a racing duplicate
        never clobbers what a client may already hold) and evict LRU
        past the bound (config.dedup_cache_size)."""
        with self._dedup_lock:
            if idem_key in self._dedup:
                return
            self._dedup[idem_key] = resp
            while len(self._dedup) > self._dedup_max:
                self._dedup.popitem(last=False)

    def _resolve_at_admission(self, request: ReduceRequest, rid: str,
                              pending: PendingResponse, status: str,
                              reason: str) -> PendingResponse:
        """Terminal verdict before the queue: resolve the slot now
        (never entered the queue, so no latency split to report)."""
        self._bump(status)
        resp = ReduceResponse(rid, status, request.method,
                              request.dtype, request.n, error=reason)
        ledger.emit("serve.respond", req=rid, status=status,
                    reason=reason[:120], **trace.request_fields(rid))
        pending.resolve(resp)
        return pending

    def _effective_deadline(self,
                            request: ReduceRequest) -> Optional[float]:
        """The request's own deadline wins; else its SLO class's
        (validated in _admission_reason, so the lookup here hits)."""
        if request.deadline_s is not None:
            return request.deadline_s
        if request.slo is not None:
            return self._slo_classes.get(request.slo)
        return None

    def _enqueue_locked(self, adm: _Admitted) -> Optional[str]:
        """Append under the lock, enforcing the per-tenant quota and
        the queue bound. A full queue admits a higher-priority arrival
        by preempting (shedding) the newest lowest-priority queued
        request — deterministic under any relay behavior because no
        device state is consulted. Returns a rejection reason or
        None."""
        request = adm.request
        if self._tenant_quota is not None:
            depth_t = sum(1 for a in self._queue
                          if a.request.tenant == request.tenant)
            if depth_t >= self._tenant_quota:
                return (f"tenant quota: {request.tenant!r} already has "
                        f"{depth_t} queued (quota {self._tenant_quota})")
        if len(self._queue) >= self._max_queue:
            victim = self._preempt_victim_locked(request.priority)
            if victim is None:
                return f"queue full (depth {len(self._queue)})"
            self._queue.remove(victim)
            self._bump("preempted")
            self._respond(victim, "shed",
                          error=(f"priority-preempted: displaced by "
                                 f"priority {request.priority} arrival"))
        self._queue.append(adm)
        return None

    def _preempt_victim_locked(self,
                               priority: int) -> Optional[_Admitted]:
        """The newest queued request of the lowest priority class,
        when that class is strictly below the arrival's (never shed
        an equal-priority peer: FIFO fairness within a class)."""
        if not self._queue:
            return None
        lowest = min(a.priority for a in self._queue)
        if lowest >= priority:
            return None
        for a in reversed(self._queue):
            if a.priority == lowest:
                return a
        return None

    def _admission_reason(self, request: ReduceRequest) -> Optional[str]:
        if self._stopping or self._stopped:
            return "engine-stopped"
        if self._draining:
            # the planned scale-down vocabulary, distinct from
            # engine-stopped BY DESIGN: the router re-routes this
            # without burning a max_retries attempt
            # (serve/router.replica_draining) because the replica is
            # healthy — admission is closed by policy, not failure
            return ("replica-draining: admission closed for planned "
                    "scale-down (in-flight work finishing)")
        if request.slo is not None \
                and request.slo not in self._slo_classes:
            return (f"unknown slo class {request.slo!r} (configured: "
                    f"{sorted(self._slo_classes) or 'none'})")
        oversized = request.nbytes > self._max_request_bytes
        if oversized and not self._stream_oversized:
            return (f"payload {request.nbytes} B exceeds the "
                    f"{self._max_request_bytes} B per-request cap "
                    "(single-message relay hazard; utils/staging.py) "
                    "and streaming is disabled")
        if request.dtype == "float64" and not oversized:
            # the coalesced stacked launch has no f64 story off-x64;
            # the streaming pipeline always does (dd pair chunks,
            # ops/stream.py) — so only the batch path gates here
            caps = self._capabilities()
            if not caps.get("supports_f64", False):
                return ("float64 unservable on this backend "
                        f"({caps.get('backend', '?')}): device f64 is "
                        "the dd pair path's job (ops/dd_reduce.py)")
        return None

    def _capabilities(self) -> dict:
        try:
            return self._ensure_executor().capabilities()
        except Exception as e:                    # capability probe
            return {"backend": f"error: {e}",     # failure: reject f64,
                    "supports_f64": False}        # keep serving 32-bit

    def _ensure_executor(self):
        # reached from both submitter threads (capability probes at
        # admission) and the worker loop — without the lock two racing
        # first calls build two executors with separate jit caches
        with self._exec_lock:
            if self._executor is None:
                from tpu_reductions_torch.serve.executor import (
                    BatchExecutor)
                self._executor = BatchExecutor(self._platform)
            return self._executor

    # -- responses ----------------------------------------------------

    def _respond(self, adm: _Admitted, status: str, *,
                 result: Optional[float] = None,
                 error: Optional[str] = None,
                 cards: Optional[int] = None) -> None:
        now = time.monotonic()
        latency = now - adm.t_enqueue
        queue_s = (adm.t_launch - adm.t_enqueue) if adm.t_launch else None
        self._bump(status)
        r = adm.request
        resp = ReduceResponse(adm.request_id, status, r.method, r.dtype,
                              r.n, result=result,
                              error=error[:200] if error else None,
                              latency_s=round(latency, 6),
                              queue_s=(round(queue_s, 6)
                                       if queue_s is not None else None),
                              batch_size=adm.batch_size, cards=cards)
        fields = {"req": adm.request_id, "status": status,
                  "latency_s": resp.latency_s, "queue_s": resp.queue_s,
                  "batch_size": adm.batch_size,
                  **trace.request_fields(adm.request_id)}
        if error:
            fields["reason"] = error[:120]
        if status == "ok" and r.slo is not None:
            # feed the class tail estimate that p99-aware admission
            # shedding consults (only ok latencies: a shed/rejected
            # request's instant resolution says nothing about service)
            self._slo.observe(r.slo, latency)
        # exactly-once: record the settlement BEFORE resolving, so a
        # duplicate racing the resolution finds the cache populated
        if r.idem_key is not None and self._dedup_settled(status, error):
            self._dedup_put(r.idem_key, resp)
        ledger.emit("serve.respond", **fields)
        adm.pending.resolve(resp)

    def _shed_locked(self, reason: str) -> None:
        """Shed every queued request with an explicit response (caller
        holds the lock for the queue swap; responses resolve outside
        any device path so this can never block)."""
        if not self._queue:
            return
        doomed = list(self._queue)
        self._queue.clear()
        ledger.emit("serve.shed", count=len(doomed), reason=reason)
        for adm in doomed:
            self._respond(adm, "shed", error=reason)

    # -- the worker ---------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait(timeout=0.05)
                if self._stopping and not self._queue:
                    return
            # bounded gather window: let a concurrent burst coalesce
            if self._coalesce_window_s > 0:
                time.sleep(self._coalesce_window_s)
            with self._cond:
                taken = list(self._queue)
                self._queue.clear()
            try:
                self._serve_round(taken)
            except Exception as e:
                # the worker must never die silently: contain, respond,
                # keep serving
                print(f"serve.engine: round failed "
                      f"({type(e).__name__}: {e}); requests get "
                      "error responses", file=sys.stderr, flush=True)
                for adm in taken:
                    if not adm.pending.done():
                        self._respond(adm, "error",
                                      error=f"{type(e).__name__}: {e}")
            with self._cond:
                if self._stopping and not self._queue:
                    return

    def _serve_round(self, taken: List[_Admitted]) -> None:
        now = time.monotonic()
        live: List[_Admitted] = []
        streams: List[_Admitted] = []
        for adm in taken:
            if adm.expired(now):
                self._respond(adm, "expired",
                              error="deadline passed in queue")
            elif adm.streamed:
                streams.append(adm)
            else:
                live.append(adm)
        for adm in streams:
            # oversized requests never coalesce (one stream already
            # saturates the transfer pipeline); they launch singly —
            # device-parallel above the shard threshold when the
            # backend has devices to split across, else streaming
            if self._should_shard(adm):
                self._launch_sharded(adm)
            else:
                self._launch_stream(adm)
        if not live:
            return
        batches = coalesce(live, max_batch=self._max_batch,
                           max_batch_bytes=self._max_request_bytes)
        launch, defer = plan_round(batches, cost_model=self._cost_model,
                                   device_window_s=self._device_window_s)
        for b in launch:
            # request ids are per-engine (r000000 collides across
            # replicas), so the exactly-once audit joins on the
            # client-supplied idempotency keys stamped HERE — the
            # launch-membership event IS the device-execution record
            # (serve/loadgen._recovery_evidence)
            idems = [a.request.idem_key for a in b.admitted]
            ledger.emit("serve.coalesce", batch=b.batch_id,
                        method=b.key[0], dtype=b.key[1], n=b.key[2],
                        size=b.size,
                        reqs=[a.request_id for a in b.admitted],
                        **({"idems": idems} if any(idems) else {}))
        if defer:
            # deferred batches keep their place ahead of new arrivals
            with self._cond:
                self._queue.extendleft(reversed(
                    [a for b in defer for a in b.admitted]))
        for b in launch:
            self._launch(b)

    def _launch(self, batch: Batch) -> None:
        now = time.monotonic()
        live = []
        for adm in batch.admitted:
            if adm.expired(now):
                self._respond(adm, "expired",
                              error="deadline passed before launch")
            else:
                live.append(adm)
        if not live:
            return
        method, dtype, n = batch.key
        with self._stats_lock:
            self._warm_keys.add(batch.key)
        est = self._cost_model.estimate(batch.key)
        ledger.emit("serve.launch", batch=batch.batch_id, size=len(live),
                    method=method, dtype=dtype, n=n,
                    est_s=round(est, 6))
        t0 = time.monotonic()
        for adm in live:
            adm.t_launch = t0
            adm.batch_size = len(live)
        try:
            self._transport.gate()
            results = self._ensure_executor().run_batch(
                method, dtype, n, [a.request.seed for a in live])
        except TransportDead as e:
            # the serving exit-3: fail the doomed batch loudly, shed
            # the queue, keep running for the next flap window
            for adm in live:
                self._respond(adm, "error", error=f"relay dead: {e}")
            with self._cond:
                self._shed_locked("relay-dead")
            return
        except Exception as e:
            # crash contained to the batch (bench/driver.crash_result
            # discipline): one broken key must not take the service
            for adm in live:
                self._respond(adm, "error",
                              error=f"{type(e).__name__}: {e}")
            return
        dt = time.monotonic() - t0
        self._cost_model.observe(batch.key, dt)
        self._bump("batches")
        self._bump("batched_requests", len(live))
        ok_count = sum(1 for r in results if r["ok"])
        ledger.emit("serve.verify", batch=batch.batch_id,
                    ok=ok_count, failed=len(live) - ok_count,
                    exec_s=round(dt, 6))
        now = time.monotonic()
        for adm, res in zip(live, results):
            if adm.expired(now):
                self._respond(adm, "expired",
                              error="deadline passed before response")
            elif res["ok"]:
                self._respond(adm, "ok", result=res["result"])
            else:
                self._respond(adm, "error",
                              error=(f"verification failed: device "
                                     f"{res['result']!r} vs oracle "
                                     f"{res['host']!r} "
                                     f"(diff {res['diff']:g})"))

    def _should_shard(self, adm: _Admitted) -> bool:
        """Device-parallel eligibility for one oversized request:
        above the shard threshold (config.shard_threshold_bytes /
        TPU_REDUCTIONS_SHARD_THRESHOLD_BYTES), more than one local
        device, and not f64 (dd pair planes stay on the streaming
        path — their plane encoding is not the per-device fold's
        accumulator shape)."""
        r = adm.request
        if not self._shard_oversized or r.dtype == "float64":
            return False
        if r.nbytes <= self._shard_threshold:
            return False
        return self._capabilities().get("device_count", 1) > 1

    def _quant_wire(self, adm: _Admitted, est_s: float) -> bool:
        """Quantized collective wire eligibility (EQuARX-style,
        collectives/quant.py): opt in only when the request carries a
        deadline whose remaining slack is tight against the cost
        model's estimate (slack < quant_slack_factor x estimate) — the
        loaded-tier regime where wire bytes buy latency — and the
        (method, dtype) is statically quantizable for SUM. The
        executor re-checks quant_supported and falls back to the
        exact wire, so a stale static table degrades accuracy of the
        CHOICE, never correctness."""
        if adm.t_deadline is None:
            return False
        r = adm.request
        if r.method != "SUM" or r.dtype not in _QUANT_SUM_DTYPES:
            return False
        slack = adm.t_deadline - time.monotonic()
        return slack < self._quant_slack_factor * max(est_s, 1e-6)

    def _launch_sharded(self, adm: _Admitted) -> None:
        """Serve one oversized request device-parallel: split across
        the executor's ranks and cards in utils/staging-bounded
        per-device chunks, per-device fold, then a collective combine
        whose algorithm comes from collectives/algorithms.select_algorithm
        (executor.run_sharded — all device work stays in the
        executor). Same transport gate, deadline checks, crash
        containment and response vocabulary as every other launch; the
        `serve.shard` event and the response carry the cards."""
        now = time.monotonic()
        if adm.expired(now):
            self._respond(adm, "expired",
                          error="deadline passed before launch")
            return
        r = adm.request
        est = self._cost_model.estimate((r.method, r.dtype, r.n))
        quantized = self._quant_wire(adm, est)
        caps = self._capabilities()
        ledger.emit("serve.shard", req=adm.request_id, method=r.method,
                    dtype=r.dtype, n=r.n, nbytes=r.nbytes,
                    quantized=quantized,
                    cards=min(caps.get("cards", 1),
                              caps.get("device_count", 1), r.n),
                    **trace.request_fields(adm.request_id))
        t0 = time.monotonic()
        adm.t_launch = t0
        adm.batch_size = 1
        try:
            self._transport.gate()
            res = self._ensure_executor().run_sharded(
                r.method, r.dtype, r.n, r.seed,
                chunk_bytes=self._stream_chunk_bytes,
                quantized=quantized)
        except TransportDead as e:
            self._respond(adm, "error", error=f"relay dead: {e}")
            with self._cond:
                self._shed_locked("relay-dead")
            return
        except Exception as e:
            self._respond(adm, "error",
                          error=f"{type(e).__name__}: {e}")
            return
        dt = time.monotonic() - t0
        self._cost_model.observe((r.method, r.dtype, r.n), dt)
        self._bump("batches")
        self._bump("batched_requests")
        self._bump("sharded")
        ledger.emit("serve.verify", batch=f"p-{adm.request_id}",
                    ok=int(res["ok"]), failed=int(not res["ok"]),
                    exec_s=round(dt, 6),
                    algorithm=res.get("algorithm"),
                    devices=res.get("devices"), cards=res.get("cards"),
                    **trace.request_fields(adm.request_id))
        if adm.expired(time.monotonic()):
            self._respond(adm, "expired",
                          error="deadline passed before response")
        elif res["ok"]:
            self._respond(adm, "ok", result=res["result"],
                          cards=res.get("cards"))
        else:
            self._respond(adm, "error",
                          error=(f"verification failed: device "
                                 f"{res['result']!r} vs oracle "
                                 f"{res['host']!r} "
                                 f"(diff {res['diff']:g})"))

    def _launch_stream(self, adm: _Admitted) -> None:
        """Serve one oversized request through the streaming pipeline
        (executor.run_stream): same transport gate, deadline checks,
        crash containment and response vocabulary as a coalesced
        launch — the request that used to bounce off the byte cap now
        resolves `ok` while the device never holds more than two
        chunks of it (ops/stream.py)."""
        now = time.monotonic()
        if adm.expired(now):
            self._respond(adm, "expired",
                          error="deadline passed before launch")
            return
        r = adm.request
        ledger.emit("serve.stream", req=adm.request_id, method=r.method,
                    dtype=r.dtype, n=r.n, nbytes=r.nbytes,
                    **trace.request_fields(adm.request_id))
        t0 = time.monotonic()
        adm.t_launch = t0
        adm.batch_size = 1
        try:
            self._transport.gate()
            res = self._ensure_executor().run_stream(
                r.method, r.dtype, r.n, r.seed,
                chunk_bytes=self._stream_chunk_bytes)
        except TransportDead as e:
            self._respond(adm, "error", error=f"relay dead: {e}")
            with self._cond:
                self._shed_locked("relay-dead")
            return
        except Exception as e:
            self._respond(adm, "error",
                          error=f"{type(e).__name__}: {e}")
            return
        dt = time.monotonic() - t0
        self._cost_model.observe((r.method, r.dtype, r.n), dt)
        self._bump("batches")
        self._bump("batched_requests")
        ledger.emit("serve.verify", batch=f"s-{adm.request_id}",
                    ok=int(res["ok"]), failed=int(not res["ok"]),
                    exec_s=round(dt, 6),
                    **trace.request_fields(adm.request_id))
        if adm.expired(time.monotonic()):
            self._respond(adm, "expired",
                          error="deadline passed before response")
        elif res["ok"]:
            self._respond(adm, "ok", result=res["result"])
        else:
            self._respond(adm, "error",
                          error=(f"verification failed: device "
                                 f"{res['result']!r} vs oracle "
                                 f"{res['host']!r} "
                                 f"(diff {res['diff']:g})"))
