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
