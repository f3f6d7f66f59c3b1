"""The share of the HBM roof the slice's reductions reach: the least time
their bytes need (each payload read once, each scalar written once, over
the card kind's data-sheet rate), over the card's busy time in the
slice's calls (the union of every kernel, copy and memset, but those
that began while the benchmark fetched answers, its `collect` span). It
reads the same work whatever kernels carry it. Nothing for a card kind
without a roof."""

from portbench.yardstick import hbm_peak


def read(s):
    peak = hbm_peak(s.kind)
    busy = s.cards[0].outside("collect").busy_s()
    if peak is None or busy <= 0 or s.ops == 0:
        return None
    return 100.0 * (s.bytes / peak) / busy
