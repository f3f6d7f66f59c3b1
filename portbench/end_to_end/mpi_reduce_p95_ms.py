"""The 95th percentile, in milliseconds, of every collective of the
window, as process 0 (the root's card) times it: from the call to the
result being ready on its card."""

from portbench.yardstick import p95


def read(window: dict) -> float:
    return p95(window["latencies_s"]) * 1e3
