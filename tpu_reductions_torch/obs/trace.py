"""Causal trace context for the flight recorder: every event gets an
identity in one span tree.

The counterpart of tpu_reductions/obs/trace.py. A (trace_id, span_id,
parent_id) context, held in a contextvar so threads see their own span
stack, that `ledger.emit` stamps onto every event and `child` pushes
children onto. `TPU_REDUCTIONS_TRACE_CTX` carries `<trace_id>:<span_id>`
into subprocesses, in the JAX package's wire form: a process that finds
it adopts the trace id and parents its root span under the propagated
span. A re-invocation that continues a trace marks the break with a
`trace.cut` event.

Host-side id bookkeeping only: no device call. With the ledger unarmed
`child` yields None and mints nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import threading
from dataclasses import dataclass
from typing import Optional

ENV_CTX = "TPU_REDUCTIONS_TRACE_CTX"

# ids propagated through the environment: safe to pass through a shell
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")


@dataclass(frozen=True)
class TraceContext:
    """One node of the span tree: its trace, its own span id, and the span
    it nests under (None for a trace root)."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    def encode(self) -> str:
        """The TPU_REDUCTIONS_TRACE_CTX wire form: `trace:span`."""
        return f"{self.trace_id}:{self.span_id}"


def new_id(nbytes: int = 6) -> str:
    """A fresh hex id from os.urandom."""
    return os.urandom(nbytes).hex()


def decode(value: Optional[str]) -> Optional[TraceContext]:
    """Parse the `trace:span` wire form; malformed input is None."""
    if not value:
        return None
    trace_id, sep, span_id = value.partition(":")
    if not sep or not _ID_RE.match(trace_id) or not _ID_RE.match(span_id):
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id)


_cv: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_reductions_torch_trace", default=None)
_root: Optional[TraceContext] = None
_root_adopted = False
_lock = threading.Lock()


def active() -> Optional[TraceContext]:
    """The context events stamp now: the innermost open span of this
    thread, else the process root, else a root adopted from
    TPU_REDUCTIONS_TRACE_CTX on first use, else None (untraced)."""
    # redlint: disable=RED023 -- contextvar isolation; get() never blocks
    ctx = _cv.get()
    if ctx is not None:
        return ctx
    if _root is not None:
        return _root
    if os.environ.get(ENV_CTX):
        return ensure_root()
    return None


def ensure_root() -> TraceContext:
    """Create (once) the process root span: adopt the trace id from
    TPU_REDUCTIONS_TRACE_CTX and parent under its span when one was
    propagated, else mint a fresh trace. Idempotent; thread-safe."""
    global _root, _root_adopted
    with _lock:
        if _root is None:
            inherited = decode(os.environ.get(ENV_CTX))
            if inherited is not None:
                _root = TraceContext(trace_id=inherited.trace_id,
                                     span_id=new_id(),
                                     parent_id=inherited.span_id)
                _root_adopted = True
            else:
                _root = TraceContext(trace_id=new_id(8), span_id=new_id())
                _root_adopted = False
        return _root


def adopted() -> bool:
    """Whether the root came from a propagated context (only a continued
    trace has a cut)."""
    return _root is not None and _root_adopted


def reset() -> None:
    """Drop the process root (tests; `ledger.disarm` calls it)."""
    global _root, _root_adopted
    with _lock:
        _root = None
        _root_adopted = False


@contextlib.contextmanager
def child():
    """A child span: a fresh span id parented under the innermost active
    span (a process root is made on demand). Events emitted inside carry
    its identity. With the ledger unarmed it yields None."""
    from tpu_reductions_torch.obs import ledger
    if not ledger.armed():
        yield None
        return
    parent = active() or ensure_root()
    ctx = TraceContext(trace_id=parent.trace_id, span_id=new_id(),
                       parent_id=parent.span_id)
    token = _cv.set(ctx)
    try:
        yield ctx
    finally:
        _cv.reset(token)


@contextlib.contextmanager
def activate(ctx: TraceContext):
    """Run a block under an explicit context."""
    token = _cv.set(ctx)
    try:
        yield ctx
    finally:
        _cv.reset(token)


def request_context(request_id: str) -> TraceContext:
    """One trace per serving request: the request id is the trace id and
    the root span id."""
    rid = str(request_id)
    return TraceContext(trace_id=rid, span_id=rid)


def request_fields(request_id: str) -> dict:
    """The explicit stamp of a per-request event, `{"trace": rid, "span":
    rid}`, passed as fields so that `ledger.emit` skips the ambient
    stamp."""
    rid = str(request_id)
    return {"trace": rid, "span": rid}


def propagation_env() -> dict:
    """The environment fragment that parents a subprocess under the
    current span: `{TPU_REDUCTIONS_TRACE_CTX: "trace:span"}`."""
    ctx = active() or ensure_root()
    return {ENV_CTX: ctx.encode()}


def cut(reason: str, **fields) -> bool:
    """Record a trace discontinuity: the previous process serving this
    trace died and this invocation continues it."""
    from tpu_reductions_torch.obs import ledger
    return ledger.emit("trace.cut", reason=reason, **fields)
