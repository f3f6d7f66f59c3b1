"""The program's own spans of its reduce call, read in-process from its
in-memory recorder (tpu_reductions_torch/obs/spans.py) for the
per-layer metrics of the host's dispatch and the card's idle time.

A program without the recorder, or a run whose entry is not the
program's (the control), has no records: every reader here then gives
None, never an error.
"""

from __future__ import annotations

import bisect
import functools
import statistics

from portbench import yardstick

SECTIONS = ("reduce.plan", "reduce.alloc", "reduce.launch", "reduce.finish")
SELF = "reduce (self)"


@functools.cache
def _recorder():
    from tpu_reductions_torch.obs import spans
    return spans if hasattr(spans, "hot_records") else None


def records(profiled: bool) -> list:
    """The recorder's records of profiled (or untraced) calls, oldest
    first; [] where there is no recorder."""
    spans = _recorder()
    return [] if spans is None else spans.hot_records(profiled)


def after_slice() -> list:
    """The untraced calls that began after the last profiled call ended:
    the window's calls that follow the traced slice."""
    traced = records(True)
    if not traced:
        return []
    last = traced[-1][-1]
    return [r for r in records(False) if r[0] > last]


def spans_us(record: tuple) -> dict:
    """Each span the record holds, as (start, end) in us from the call's
    start."""
    t0 = record[0]
    return {name: ((a - t0) * 1e-3, (b - t0) * 1e-3)
            for name, (a, b) in _recorder().hot_sections(record).items()}


def _length(ends: tuple) -> float:
    return ends[1] - ends[0]


def durations_us(recs: list, name: str) -> list:
    """The durations of span `name` over the records that hold it; SELF
    is `reduce` less the children it holds."""
    out = []
    for r in recs:
        sec = spans_us(r)
        if name == SELF:
            out.append(_length(sec["reduce"]) - sum(
                _length(sec[c]) for c in SECTIONS if c in sec))
        elif name in sec:
            out.append(_length(sec[name]))
    return out


def median_us(name: str):
    """The median of span `name` over the untraced calls after the
    slice, or None where none holds it."""
    d = durations_us(after_slice(), name)
    return statistics.median(d) if d else None


def summary_lines() -> list:
    """Each span's count, median and p95 over the untraced calls after
    the slice, and `reduce`'s self time."""
    recs = after_slice()
    out = []
    for name in ("reduce",) + SECTIONS + (SELF,):
        d = durations_us(recs, name)
        if d:
            out.append(f"program span {name}: {len(d)} untraced calls, "
                       f"median {statistics.median(d)!r} us, p95 "
                       f"{yardstick.p95(d)!r} us")
    return out


def _overlap(gaps: list, starts: list, lo: float, hi: float) -> float:
    """The length of [lo, hi] that the sorted, disjoint gaps cover."""
    total = 0.0
    at = max(0, bisect.bisect_right(starts, lo) - 1)
    while at < len(gaps) and gaps[at][0] < hi:
        s, e = gaps[at]
        total += max(0.0, min(e, hi) - max(s, lo))
        at += 1
    return total


def idle_split(s):
    """The card's idle time in the slice that falls inside each of the
    program's spans, in us summed over the slice's calls, with the
    slice's whole idle time under "slice" and its calls under "calls";
    None where the profiled records do not match the slice's calls.
    "call" holds the idle time inside the benchmark's `call` spans, by
    the same overlap (the `breakdown` gives each gap whole to the span
    open at its midpoint instead).

    The k-th of the last N profiled records is laid on the k-th of the
    slice's N `call` spans, its start at the span's start; each idle gap
    of the card then counts, in each span, for the stretch they share.
    A record's stamps and the trace's clock differ by an offset only,
    which the anchor removes; what is left is the host's step from the
    `call` span's start to the program's entry."""
    card = s.cards[0]
    call_spans = sorted((st, e) for name, st, e in card.spans
                        if name == "call")
    calls = [st for st, _ in call_spans]
    n = len(calls)
    recs = records(True)[-n:] if n else []
    if n == 0 or n != s.ops or len(recs) != n:
        return None
    gaps = yardstick.gaps(((a, b) for a, b, _ in card.device),
                          card.lo, card.hi)
    starts = [g[0] for g in gaps]
    split = dict.fromkeys(("reduce",) + SECTIONS + (SELF,), 0.0)
    for anchor, rec in zip(calls, recs):
        for name, (a, b) in spans_us(rec).items():
            split[name] += _overlap(gaps, starts, anchor + a, anchor + b)
    split[SELF] = split["reduce"] - sum(split[name] for name in SECTIONS)
    split["slice"] = sum(e - st for st, e in gaps)
    split["call"] = sum(_overlap(gaps, starts, st, e) for st, e in call_spans)
    split["calls"] = n
    return split
