"""Shared by the port's parity tests: put the JAX package and the port on
the same payload and oracle route.

Both packages fill and verify with their native library (csrc/oracle.cpp)
where it builds and with numpy otherwise, and the two routes give
different data for the same seed. Each package reads
TPU_REDUCTIONS_NO_NATIVE once, at its first load, so the route is chosen
by patching the loaders, not by setting the variable mid-run.
"""

import time

import pytest

from tpu_reductions.ops import oracle as jax_oracle
from tpu_reductions_torch.ops import oracle


def load_jax_native(monkeypatch) -> None:
    """Load the JAX package's native library; again, for up to 10 s, if a
    concurrent build (another test worker's `make`) left it unloaded in
    this process."""
    for _ in range(10):
        if jax_oracle._load() is not None:
            return
        monkeypatch.setattr(jax_oracle, "_lib", None)
        monkeypatch.setattr(jax_oracle, "_lib_tried", False)
        time.sleep(1)


def use_route(monkeypatch, route: str) -> None:
    """Put both packages' payload and oracle on `route`: numpy (both
    native libraries off) or native (both loaded)."""
    if route == "numpy":
        monkeypatch.setattr(jax_oracle, "_load", lambda: None)
        monkeypatch.setattr(oracle, "_load", lambda: None)
        return
    load_jax_native(monkeypatch)
    assert jax_oracle.native_available() and oracle.native_available()


@pytest.fixture
def numpy_oracle(monkeypatch):
    """Both packages on their numpy payload and oracle."""
    use_route(monkeypatch, "numpy")


@pytest.fixture
def both_native(monkeypatch):
    """Both packages on their native library."""
    use_route(monkeypatch, "native")


def fixed_slope(chained, x, k_lo, k_hi, reps=5, **_):
    """time_chained's stand-in for both packages: the chain runs once
    (through its real machinery) and the slope is 1 ms. At test sizes the
    host's noise would decide between PASSED and WAIVED."""
    from tpu_reductions_torch.utils.timing import Stopwatch
    chained(x, k_lo)
    return Stopwatch(total_s=1e-3, sessions=1, samples=[1e-3])


@pytest.fixture
def fixed_slopes(monkeypatch):
    """Both drivers' chained slopes fixed at 1 ms (fixed_slope)."""
    from tpu_reductions.utils import timing as jax_timing
    from tpu_reductions_torch.bench import driver
    monkeypatch.setattr(driver, "time_chained", fixed_slope)
    monkeypatch.setattr(jax_timing, "time_chained", fixed_slope)
