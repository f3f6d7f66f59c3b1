"""The SDK's verified throughput: the payload bytes of every reduction
completed in the window (n x itemsize each), over the window's seconds,
in GB/s (10^9 bytes)."""


def read(window: dict) -> float:
    return window["bytes"] / window["seconds"] / 1e9
