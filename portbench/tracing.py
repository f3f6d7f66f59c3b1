"""The traced slice: torch.profiler over a bounded part of the window,
read back from its chrome trace into device intervals and the
benchmark's own host spans.

A traced run records its spans (`record_function`) around its calls into
the program: `call` (the program's entry, up to its return), `sync` (the
wait for the card), `rotate` (the benchmark's bookkeeping between calls),
`collect` (fetching answers for the check), `barrier` (the processes'
agreement on the window) and `collective` (one collective, awaited).
`slice` encloses the traced calls. Spans inside the program are its own
business.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from contextlib import nullcontext

from portbench import yardstick

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("call", "sync", "rotate", "collect", "barrier", "collective")
SLICE = "slice"
TOP = 10


def start(device_type: str):
    """A started profiler: the host's ops, and the card's when there is
    one."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def span(name: str, on: bool):
    """The benchmark's span `name` while the profiler records, else
    nothing."""
    if not on:
        return nullcontext()
    from torch.profiler import record_function
    return record_function(name)


class SliceMark:
    """The `slice` span, opened at the first traced call and closed after
    the last."""

    def __init__(self) -> None:
        from torch.profiler import record_function
        self._rf = record_function(SLICE)
        self._rf.__enter__()

    def close(self) -> None:
        self._rf.__exit__(None, None, None)


@dataclasses.dataclass
class Card:
    """One card's part of a traced slice, in microseconds of its process's
    trace clock: the slice's bounds, every device interval (start, end,
    name) in it, and the host spans (name, start, end) of the process
    that drives the card."""

    lo: float
    hi: float
    device: list
    spans: list

    @property
    def length_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def busy_s(self, keep=None) -> float:
        """Seconds in which some device interval ran (those whose name
        `keep` accepts, when given)."""
        return yardstick.union_length(
            ((s, e) for s, e, name in self.device
             if keep is None or keep(name)), self.lo, self.hi) * 1e-6

    def during(self, *names: str) -> "Card":
        """This card with only the device intervals that began while one
        of the host's spans `names` was open (the work those spans
        launched and awaited)."""
        began = self._began_in(names)
        return Card(self.lo, self.hi,
                    [iv for iv in self.device if began(iv)], self.spans)

    def outside(self, *names: str) -> "Card":
        """This card without the device intervals that began while one of
        the host's spans `names` was open."""
        began = self._began_in(names)
        return Card(self.lo, self.hi,
                    [iv for iv in self.device if not began(iv)], self.spans)

    def _began_in(self, names: tuple):
        spans = sorted((s, e) for n, s, e in self.spans if n in names)
        starts = [s for s, _ in spans]

        def began(iv: tuple) -> bool:
            at = bisect.bisect_right(starts, iv[0]) - 1
            return at >= 0 and iv[0] <= spans[at][1]
        return began

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Slice:
    """What the per-layer readers read: each card's trace, the slice's
    operations (calls or collectives), the least bytes its reductions
    move, the host's dispatch seconds of each call, and the device kind."""

    cards: list
    ops: int
    bytes: int
    dispatch_s: list
    kind: str


def read_card(prof) -> Card:
    """Export the stopped profiler's chrome trace, and keep the `slice`
    span's stretch of it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    complete = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in complete
             if e.get("cat") == "user_annotation" and e["name"] == SLICE]
    if not marks:
        return Card(0.0, 0.0, [], [])
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    device, spans = [], []
    for e in complete:
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        if end < lo or s > hi:
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append((s, end, e["name"]))
        elif e.get("cat") == "user_annotation" and e["name"] in SPANS:
            spans.append((e["name"], s, end))
    return Card(lo, hi, device, spans)


def breakdown(card: Card) -> dict:
    """The device operations that took most time in the slice, and its
    idle stretches summed by the benchmark's span open on the host at
    their midpoint (the innermost, the latest begun), in seconds."""
    ops: dict = {}
    for s, e, name in card.device:
        s, e = max(s, card.lo), min(e, card.hi)
        if e > s:
            ops[name[:200]] = ops.get(name[:200], 0.0) + (e - s) * 1e-6
    idle: dict = {}
    spans = sorted(card.spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    for s, e in yardstick.gaps(((a, b) for a, b, _ in card.device),
                               card.lo, card.hi):
        mid = (s + e) / 2
        # the benchmark's spans follow one another, so the latest begun
        # is the only one that can be open
        at = bisect.bisect_right(starts, mid) - 1
        name = spans[at][0] if at >= 0 and spans[at][2] >= mid else "none"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
