"""The program's span `reduce.alloc` of a reduce call: k6's two
torch.empty; at the median of the untraced calls that follow the traced
slice, in microseconds, by the program's in-memory recorder. Nothing
where the program records no such span."""

from portbench import program_spans


def read(s):
    return program_spans.median_us("reduce.alloc")
