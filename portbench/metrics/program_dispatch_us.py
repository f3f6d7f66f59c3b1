"""The program's own time of a reduce call, entry to return (its span
`reduce`), at the median of the untraced calls that follow the traced
slice, in microseconds: the host's dispatch without the profiler's
callbacks, by the program's in-memory recorder. Nothing where the
program records no spans."""

from portbench import program_spans


def read(s):
    return program_spans.median_us("reduce")


def lines(s):
    return program_spans.summary_lines()
