"""Span API over the flight-recorder ledger (obs/ledger.py).

The counterpart of tpu_reductions/obs/spans.py. A span is one host-side
region worth attribution: `<name>.start` on entry and `<name>.end` (with
`dur_s`, and `error` when the region raised) on exit, the pair under one
child trace context (obs/trace.py), so nested spans parent under it and
obs/trace_export.py rebuilds the tree offline. Host-side only: no device
sync. With the ledger unarmed a span is one attribute test.
"""

from __future__ import annotations

import contextlib
import time

from tpu_reductions_torch.obs import ledger, trace

event = ledger.emit     # alias: seams import one module for both


@contextlib.contextmanager
def span(name: str, **fields):
    """Bracket one host-side region with `<name>.start` / `<name>.end`
    events; `dur_s` is monotonic wall-clock, `error` records a raising
    region (the exception is re-raised untouched — spans observe,
    never contain). The pair share a child trace context so the region
    is one node of the span tree."""
    if not ledger.armed():
        yield
        return
    with trace.child():
        ledger.emit(name + ".start", **fields)
        t0 = time.monotonic()
        try:
            yield
        except BaseException as e:
            ledger.emit(name + ".end",
                        dur_s=round(time.monotonic() - t0, 6),
                        error=f"{type(e).__name__}: {e}"[:200], **fields)
            raise
        ledger.emit(name + ".end", dur_s=round(time.monotonic() - t0, 6),
                    **fields)
