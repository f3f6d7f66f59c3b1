"""reduce.c's rate (reduce.c:79): all ranks' payload bytes of every
collective completed in the window, over the window's seconds, in GB/s
(10^9 bytes)."""


def read(window: dict) -> float:
    return window["bytes"] / window["seconds"] / 1e9
