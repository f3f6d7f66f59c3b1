"""The program's span `reduce.finish` of a reduce call: finish's torch
reduction of the accumulator; at the median of the untraced calls that
follow the traced slice, in microseconds, by the program's in-memory
recorder. Nothing where the program records no such span."""

from portbench import program_spans


def read(s):
    return program_spans.median_us("reduce.finish")
