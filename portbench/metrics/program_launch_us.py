"""The program's span `reduce.launch` of a reduce call: k6's launch
through ops/_cuda.py as a whole (the library, the device guard, the
pointers, the stream, the ctypes call and its check); at the median of
the untraced calls that follow the traced slice, in microseconds, by the
program's in-memory recorder. Nothing where the program records no such
span."""

from portbench import program_spans


def read(s):
    return program_spans.median_us("reduce.launch")
