"""The 95th percentile, in microseconds, of every call's latency in the
window: from the call to its result being ready on the card."""

from portbench.yardstick import p95


def read(window: dict) -> float:
    return p95(window["latencies_s"]) * 1e6
