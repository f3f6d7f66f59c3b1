"""The serving engine's typed request and response.

The counterpart of tpu_reductions/serve/request.py. One `ReduceRequest`
asks to reduce an `n`-element payload of `dtype` with `method`,
optionally within `deadline_s`. The payload is made engine-side from the
request's seed (the filler the benchmark uses), so a request is a few
bytes on the wire. Validation uses the port's `config.SERVED_METHODS`
and `DTYPE_ALIASES`, with the JAX package's refusal words. No device
call here.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from tpu_reductions_torch.config import DTYPE_ALIASES, SERVED_METHODS

# every submitted request resolves to exactly one of these:
#   ok        executed, verified, result attached
#   error     the executed path failed (device error, verification
#             failure, dead transport); the reason is in .error
#   rejected  refused at admission; never entered the queue
#   expired   its deadline passed before a result existed
#   shed      dropped by load shedding (dead transport, stop, preemption)
STATUSES = ("ok", "error", "rejected", "expired", "shed")

# bytes an element, per canonical dtype (numpy has no bfloat16)
ITEMSIZE = {"int32": 4, "float32": 4, "float64": 8, "bfloat16": 2}


class TransportDead(RuntimeError):
    """The transport gate found no relay at launch time: the engine fails
    the batch, sheds the queue and keeps running."""


@dataclasses.dataclass
class ReduceRequest:
    """One reduction request, validated at construction."""

    method: str
    dtype: str
    n: int
    seed: int = 0
    deadline_s: Optional[float] = None   # relative to submission
    value: float = 1.0                   # scheduling weight (knapsack)
    tenant: str = "default"              # per-tenant quota bucket
    priority: int = 1                    # higher preempts lower on a
    #                                      full queue
    slo: Optional[str] = None            # SLO class, resolved to a
    #                                      deadline by the engine
    idem_key: Optional[str] = None       # idempotency key: requests with
    #                                      one key settle to one terminal
    #                                      response

    def __post_init__(self) -> None:
        self.method = self.method.upper()
        if self.method not in SERVED_METHODS:
            raise ValueError(f"method must be one of {SERVED_METHODS}, "
                             f"got {self.method!r}")
        if self.dtype not in DTYPE_ALIASES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        self.dtype = DTYPE_ALIASES[self.dtype]
        if self.n <= 0:
            raise ValueError("n must be positive")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        if self.value <= 0:
            raise ValueError("value must be positive")
        if not isinstance(self.tenant, str) or not self.tenant:
            raise ValueError("tenant must be a non-empty string")
        if not isinstance(self.priority, int) or self.priority < 0:
            raise ValueError("priority must be a non-negative int")
        if self.slo is not None and (not isinstance(self.slo, str)
                                     or not self.slo):
            raise ValueError("slo must be a non-empty string (or None)")
        if self.idem_key is not None and (
                not isinstance(self.idem_key, str) or not self.idem_key):
            raise ValueError("idem_key must be a non-empty string "
                             "(or None)")

    @property
    def nbytes(self) -> int:
        """The payload's size: what admission's byte cap and the
        batcher's byte bound meter."""
        return self.n * ITEMSIZE[self.dtype]


@dataclasses.dataclass
class ReduceResponse:
    """One terminal outcome. `latency_s` runs from submission to the
    response; `queue_s` is its admission-to-launch share. `cards`, set
    only on a sharded request's response, is the number of cards its
    shards folded on."""

    request_id: str
    status: str
    method: str
    dtype: str
    n: int
    result: Optional[float] = None
    error: Optional[str] = None
    latency_s: Optional[float] = None
    queue_s: Optional[float] = None
    batch_size: Optional[int] = None
    cards: Optional[int] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def to_dict(self) -> dict:
        """JSON-ready: the TCP front end's response line (the JAX
        package's, with `cards` added where it is set)."""
        d = dataclasses.asdict(self)
        if d["cards"] is None:
            del d["cards"]
        return d


class PendingResponse:
    """What `ServeEngine.submit` returns: resolved exactly once, waitable
    with a timeout, thread-safe."""

    def __init__(self, request_id: str) -> None:
        self.request_id = request_id
        self._event = threading.Event()
        self._response: Optional[ReduceResponse] = None
        self._lock = threading.Lock()
        self._callbacks: list = []

    def resolve(self, response: ReduceResponse) -> None:
        """Attach the terminal response; the first resolution wins."""
        with self._lock:
            if self._response is not None:
                return
            self._response = response
            callbacks, self._callbacks = self._callbacks, []
        self._event.set()
        for fn in callbacks:
            fn(response)

    def add_done_callback(self, fn) -> None:
        """Run `fn(response)` on resolution (at once when resolved)."""
        with self._lock:
            if self._response is None:
                self._callbacks.append(fn)
                return
            response = self._response
        fn(response)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ReduceResponse:
        """Block until resolved; TimeoutError instead of None."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.request_id} unresolved "
                               f"after {timeout}s")
        assert self._response is not None
        return self._response
