"""The card's idle time inside the program's reduce call, in
microseconds a call of the traced slice: each of the slice's `call`
spans carries the program's record of that call (obs/spans.py), laid at
the span's start, and every idle gap of the card counts for the stretch
it shares with the call's span `reduce`. Nothing where the program's
profiled records do not match the slice's calls one for one."""

from portbench import program_spans


def read(s):
    split = program_spans.idle_split(s)
    return None if split is None else split["reduce"] / split["calls"]


def lines(s):
    split = program_spans.idle_split(s)
    if split is None:
        return []
    n = split["calls"]
    parts = ", ".join(f"{name} {split[name] / n!r}" for name in
                      program_spans.SECTIONS + (program_spans.SELF,))
    return [f"program idle a call (us): {parts}; outside the program "
            f"{(split['slice'] - split['reduce']) / n!r}; inside the "
            f"benchmark's call span {split['call'] / n!r}"]
