"""The kernels' build directory as the compile cache, and the cold/warm
verdict over it.

The counterpart of tpu_reductions/utils/compile_cache.py, mapped onto
what the card caches: the JAX package's persistent `.jax_cache/` holds
compiled executables; the port's counterpart is the directory that
ops/_cuda.build compiles csrc/*.cu into (`_build/lib<name>.so`), where a
library that is not stale (`_cuda._stale`: newer than its source and
every header) is loaded without a compile.

  * `enable(path=None)` names the build directory the verdicts read
    (default: the package's `_build/`). It does not move the build.
  * `fingerprint()` is the set of fresh libraries in that directory,
    each with its modification stamp: a library built during a bracket
    appears (or changes stamp) across it.
  * `verdict(before, after)`: `cold` when a library was built, `warm`
    over a directory that gained nothing but holds libraries,
    `untracked` with nothing to consult.

TPU_REDUCTIONS_NO_COMPILE_CACHE=1 turns the verdicts off (every
fingerprint is empty); it cannot turn the build off. Stdlib only: it
imports no torch, so the scheduler reads it in a light process.
"""

from __future__ import annotations

import os
from typing import FrozenSet, Optional

ENV_DISABLE = "TPU_REDUCTIONS_NO_COMPILE_CACHE"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")

# the directory enable() named (None: the default)
_active_dir: Optional[str] = None


def disabled() -> bool:
    """TPU_REDUCTIONS_NO_COMPILE_CACHE=1: no verdicts."""
    return os.environ.get(ENV_DISABLE) == "1"


def default_dir() -> str:
    """The package's `_build/`, where ops/_cuda.build writes."""
    return os.path.join(_PKG, "_build")


def active_dir() -> Optional[str]:
    """The directory verdicts read: the named one, else the default;
    None when the knob disables the verdicts."""
    if disabled():
        return None
    return _active_dir or default_dir()


def enable(path: Optional[str] = None) -> Optional[str]:
    """Name the build directory the verdicts read (default `_build/`);
    returns it, or None when disabled."""
    global _active_dir
    if disabled():
        return None
    _active_dir = os.fspath(path) if path is not None else default_dir()
    return _active_dir


def _mtime(path: str) -> Optional[float]:
    try:
        return os.stat(path).st_mtime
    except OSError:
        return None


def fingerprint() -> FrozenSet[str]:
    """`lib<name>.so@<mtime_ns>` for every library in the directory
    that is fresh against its csrc/<name>.cu and csrc's headers (the
    rule of ops/_cuda._stale); empty when disabled or unreadable."""
    d = active_dir()
    if d is None:
        return frozenset()
    try:
        names = os.listdir(_CSRC)
    except OSError:
        return frozenset()
    headers = [_mtime(os.path.join(_CSRC, h)) for h in names
               if h.endswith(".cuh")]
    newest_header = max((m for m in headers if m is not None), default=0.0)
    out = set()
    for src in names:
        if not src.endswith(".cu"):
            continue
        lib = os.path.join(d, f"lib{src[:-3]}.so")
        try:
            st = os.stat(lib)
        except OSError:
            continue
        src_m = _mtime(os.path.join(_CSRC, src)) or 0.0
        if st.st_mtime >= max(src_m, newest_header):
            out.add(f"lib{src[:-3]}.so@{st.st_mtime_ns}")
    return frozenset(out)


def verdict(before: FrozenSet[str], after: FrozenSet[str]) -> str:
    """`cold` (a library was built across the bracket), `warm` (a full
    directory gained nothing) or `untracked` (nothing to consult)."""
    if after - before:
        return "cold"
    if after:
        return "warm"
    return "untracked"
