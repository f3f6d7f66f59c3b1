"""Span API over the flight-recorder ledger (obs/ledger.py).

The counterpart of tpu_reductions/obs/spans.py. A span is one host-side
region worth attribution: `<name>.start` on entry and `<name>.end` (with
`dur_s`, and `error` when the region raised) on exit, the pair under one
child trace context (obs/trace.py), so nested spans parent under it and
obs/trace_export.py rebuilds the tree offline. Host-side only: no device
sync. With the ledger unarmed a span is one attribute test.

The reduce call, too short for ledger events, has its own recorder
below: spans kept in memory (`hot_begin`, `hot_records`), and the count
of its calls that take k6's bound launch (`K6_BOUND`).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from array import array
from typing import Optional

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


# ---------------------------------------------------------------------------
# The reduce call's recorder: in memory, for a path of tens of µs a call
# ---------------------------------------------------------------------------
#
# `span` above writes two ledger events a region; the reduce call
# (ops/kernel_reduce.make_staged_reduce's reduce_fn) takes 55-110 µs and
# cannot carry them. Its spans are perf_counter_ns stamps instead, one
# record a call, kept in two preallocated rings and read at the end:
#
#   reduce          reduce_fn's entry to its return, the parent of:
#   reduce.plan     entry to k6's scratch: on the bound path the binding
#                   check, on a bind or the unbound path the checks,
#                   plan_k6 with its cached queries and the dtype
#   reduce.alloc    the stream's scratch: the bound path's lookup, or two
#                   torch.empty
#   reduce.launch   k6's ctypes call (with the device guard, where the
#                   device is not current)
#   reduce.finish   finish's op.reduce (host_finish with --cpufinal)
#
# k7-k10, and dd_reduce.make_dd_staged_reduce's reduce_fn, record
# `reduce` and `reduce.finish` alone. `reduce`'s self time is its
# duration less its children's.
#
# Off (the default) a call reads the profiler's enabled flag and the
# recorder's own, and nothing more. The recorder arms the first time a
# call sees a torch profiler recording, or on `arm_hot()`, and stays
# armed until `disarm_hot()`. Armed, a call made while the profiler
# records goes to the profiled ring, every other call to the untraced
# ring, so the untraced calls that follow a traced slice never overwrite
# it. While the profiler records, each span is also a profiler range
# named `port.<span>`, on the device trace's clock; a span's stamps
# enclose its range's own cost. No ledger event is written.

HOT_SPANS = ("reduce", "reduce.plan", "reduce.alloc", "reduce.launch",
             "reduce.finish")
# a record's stamps, by slot; 0 where the call had no such boundary
START, PLAN_END, ALLOC_END, LAUNCH_END, FINISH_START, END = range(6)
WIDTH = 6
# each span's first and last slot
SLOTS = {"reduce": (START, END), "reduce.plan": (START, PLAN_END),
         "reduce.alloc": (PLAN_END, ALLOC_END),
         "reduce.launch": (ALLOC_END, LAUNCH_END),
         "reduce.finish": (FINISH_START, END)}
# the range a stamp opens while the profiler records
_OPENS = {PLAN_END: "port.reduce.alloc", ALLOC_END: "port.reduce.launch",
          FINISH_START: "port.reduce.finish"}
PROFILED_CALLS = 8192
UNTRACED_CALLS = 65536


class _Ring:
    """The newest `calls` records of WIDTH stamps, preallocated."""

    def __init__(self, calls: int) -> None:
        self.calls = calls
        self.data = array("q", bytes(8 * WIDTH * calls))
        self.written = 0

    def put(self, stamps: array) -> None:
        at = self.written % self.calls * WIDTH
        self.data[at:at + WIDTH] = stamps
        self.written += 1

    def records(self) -> list:
        first = max(0, self.written - self.calls)
        out = []
        for k in range(first, self.written):
            at = k % self.calls * WIDTH
            out.append(tuple(self.data[at:at + WIDTH]))
        return out


class HotRecord:
    """One thread's record of one reduce call, open from `hot_begin`
    until `end` or `drop`; only then does it reach a ring, so two
    threads' calls never mix. A stamp on a record that is not open is
    dropped."""

    __slots__ = ("stamps", "open", "profiled", "ranges")

    def __init__(self) -> None:
        self.stamps = array("q", bytes(8 * WIDTH))
        self.open = False
        self.profiled = False
        self.ranges = []         # open profiler ranges, outermost first

    def plan(self) -> None:
        """k6 on the card: open `port.reduce.plan` (its stamps are
        START and PLAN_END)."""
        if self.open and self.profiled:
            self._enter("port.reduce.plan")

    def mark(self, slot: int) -> None:
        if not self.open:
            return
        self.stamps[slot] = time.perf_counter_ns()
        if self.profiled:
            while len(self.ranges) > 1:
                self.ranges.pop().__exit__(None, None, None)
            if slot in _OPENS:
                self._enter(_OPENS[slot])

    def end(self) -> None:
        """Stamp the return and hand the record to its ring."""
        if not self.open:
            return
        self._close()
        self.stamps[END] = time.perf_counter_ns()
        HOT.commit(self.stamps, self.profiled)

    def drop(self) -> None:
        """The call raised: close the record without keeping it."""
        if self.open:
            self._close()

    def _enter(self, name: str) -> None:
        rf = _record_function(name)
        rf.__enter__()
        self.ranges.append(rf)

    def _close(self) -> None:
        while self.ranges:
            self.ranges.pop().__exit__(None, None, None)
        self.open = False


class HotRecorder:
    """The process's two rings, its arming and each thread's record."""

    def __init__(self) -> None:
        self.armed = False
        self.profiled = _Ring(PROFILED_CALLS)
        self.untraced = _Ring(UNTRACED_CALLS)
        self.threads = threading.local()
        self._lock = threading.Lock()

    def record(self) -> HotRecord:
        """The calling thread's record."""
        try:
            return self.threads.record
        except AttributeError:
            rec = self.threads.record = HotRecord()
            return rec

    def commit(self, stamps: array, profiled: bool) -> None:
        with self._lock:
            (self.profiled if profiled else self.untraced).put(stamps)


HOT = HotRecorder()
_record_function = None     # torch's, bound by the first profiled call
_modules = sys.modules
_UNSTAMPED = array("q", bytes(8 * (WIDTH - 1)))


def hot_begin() -> Optional[HotRecord]:
    """Open the calling thread's record of a reduce call and stamp its
    start, or return None (the recorder off, or a record already open on
    this thread)."""
    global _record_function
    # whether a torch profiler records (torch is never imported here: a
    # process without it has no profiler)
    prof = _modules.get("torch.autograd.profiler")
    profiled = prof is not None and prof._is_profiler_enabled
    if not (profiled or HOT.armed):
        return None
    rec = HOT.record()
    if rec.open:
        return None
    rec.stamps[START] = time.perf_counter_ns()
    rec.stamps[START + 1:] = _UNSTAMPED
    rec.open = True
    rec.profiled = profiled
    if profiled:
        HOT.armed = True
        if _record_function is None:
            # the C++ range: a call's five cost 13-16 us on the host of
            # an H100 machine, where `record_function`'s cost 63-71
            from torch._C._profiler import _RecordFunctionFast
            _record_function = _RecordFunctionFast
        rec._enter("port.reduce")
    return rec


def hot_call(rec: HotRecord, device, finish):
    """`finish(device())` on an open record: stamp where the finish
    begins and end the record, or drop it if either raises."""
    try:
        acc = device()
        rec.mark(FINISH_START)
        out = finish(acc)
    except BaseException:
        rec.drop()
        raise
    rec.end()
    return out


def arm_hot() -> None:
    """Record every reduce call from now on, profiled or not."""
    HOT.armed = True


def disarm_hot() -> None:
    """Stop recording calls made while no profiler records."""
    HOT.armed = False


def reset_hot() -> None:
    """Disarm and empty both rings (the recorder is process-wide)."""
    global HOT
    HOT = HotRecorder()


def hot_records(profiled: bool) -> list:
    """The kept records of calls made while the profiler recorded (or,
    with `profiled` false, of the others), oldest first, each a tuple of
    WIDTH perf_counter_ns stamps."""
    ring = HOT.profiled if profiled else HOT.untraced
    with HOT._lock:
        return ring.records()


def hot_sections(record: tuple) -> dict:
    """Each span a record holds, as (start_ns, end_ns)."""
    return {name: (record[a], record[b]) for name, (a, b) in SLOTS.items()
            if record[a] and record[b]}


# ---------------------------------------------------------------------------
# How often the reduce call takes k6's bound launch
# ---------------------------------------------------------------------------


class BoundCount:
    """k6's reduce calls on the card since the process began (or the last
    `reset`), by the way each went (ops/kernel_reduce.K6Binding): `hits`
    took their reduce_fn's bound launch, `binds` made it, `misses` took
    the unbound path (a tensor the binding does not match, or a stream
    capturing a CUDA graph). Plain increments, always on: one a call."""

    __slots__ = ("hits", "binds", "misses")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.hits = self.binds = self.misses = 0

    def calls(self) -> int:
        return self.hits + self.binds + self.misses


K6_BOUND = BoundCount()
