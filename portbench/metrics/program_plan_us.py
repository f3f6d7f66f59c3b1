"""The program's span `reduce.plan` of a reduce call: from its entry to
just before k6's first allocation (the checks, plan_k6 with its cached
queries, the accumulator's dtype); at the median of the untraced calls
that follow the traced slice, in microseconds, by the program's
in-memory recorder. Nothing where the program records no such span."""

from portbench import program_spans


def read(s):
    return program_spans.median_us("reduce.plan")
