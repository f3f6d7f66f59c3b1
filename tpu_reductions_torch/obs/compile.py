"""The compile observatory: each build and first call as a typed,
persisted observation.

The counterpart of tpu_reductions/obs/compile.py, mapped onto the card,
where what compiles is nvcc's build of csrc/*.cu (ops/_cuda.build) and
what the cache holds is its build directory (utils/compile_cache.py):

  * `compile_span(surface, **fields)` brackets one compile seam with
    `compile.start` / `compile.end` events carrying the surface, the
    platform, the caller's fields, the wall seconds and the cache
    verdict (cold when a library was built across the bracket, warm
    over a full directory) with `cache_new`, the libraries built. An
    armed store records the row. exec/core.observe_compile goes through
    it.
  * JAX's `probe_lower_compile` (AOT lower, then compile) is left out:
    nothing is lowered on the card, and the build plus a surface's first
    call is what bench/warm.py times and records (`lower_s` null).
  * `CompileLedger` persists per-surface rows at out/compile_ledger.json
    (TPU_REDUCTIONS_COMPILE_LEDGER arms it; bench/warm.py writes through
    it, so the file has one writer, and exec/cost.py reads it), in the
    JAX artifact's shape `{"kind": "compile-observatory", "version": 1,
    "complete": bool, "surfaces": [...]}`, keyed (surface, platform,
    verdict), with the JAX package's one deliberate deviation from the
    bench/resume contract: prior rows merge in even from a
    `complete: true` artifact, because the build directory outlives a
    run as the persistent cache does.
  * `CompileModel` is the read side for sched/priors.py: which surfaces
    are warm, and the cold-minus-warm seconds the cache banks;
    `compile_markdown` is its report table (bench/regen.py).

No device call at import: the scheduler reads compile models in a light
process. TPU_REDUCTIONS_OBS_DISABLE=1 turns the store off with the rest
of the recorder.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils import compile_cache

ENV_PATH = "TPU_REDUCTIONS_COMPILE_LEDGER"
DEFAULT_LEDGER = os.path.join("out", "compile_ledger.json")

_META = {"kind": "compile-observatory", "version": 1}


def _platform() -> Optional[str]:
    """'gpu' when this process has initialized CUDA, 'cpu' when it
    imported torch without, None when it never imported torch (the
    scheduler); never initializes anything itself."""
    mod = sys.modules.get("torch")
    if mod is None:
        return None
    try:
        return "gpu" if mod.cuda.is_initialized() else "cpu"
    except Exception:
        return None


def _row_key(row: dict) -> Tuple:
    return (row.get("surface"), row.get("platform"), row.get("verdict"))


class CompileLedger:
    """The persisted per-surface observation store (module docstring
    has the contract and its one documented deviation)."""

    def __init__(self, path: str) -> None:
        self.path = os.fspath(path)
        self._rows: Dict[Tuple, dict] = {}
        prior = self._load_prior()
        # the prior artifact's completeness (None when there was none):
        # bench/warm.py resumes the surfaces of an interrupted pass
        self.prior_complete = (prior.get("complete")
                               if prior is not None else None)
        if prior is not None:
            for row in prior.get("surfaces", []):
                if isinstance(row, dict) and row.get("surface"):
                    self._rows[_row_key(row)] = row

    def _load_prior(self) -> Optional[dict]:
        try:
            data = json.loads(open(self.path).read())
        except (OSError, ValueError):
            return None   # absent or truncated pre-atomic: start empty
        if not isinstance(data, dict):
            return None
        if not all(data.get(k) == v for k, v in _META.items()):
            return None   # different contract version: never merge
        return data

    @property
    def rows(self) -> List[dict]:
        return sorted(self._rows.values(),
                      key=lambda r: (str(r.get("surface")),
                                     str(r.get("platform")),
                                     str(r.get("verdict"))))

    def record(self, row: dict) -> None:
        """Replace-or-insert one observation and persist atomically —
        the persist-per-row live-window discipline (a flap loses
        nothing already observed)."""
        key = _row_key(row)
        prev = self._rows.get(key)
        row = dict(row)
        row["count"] = (prev.get("count", 1) + 1) if prev else 1
        self._rows[key] = row
        self._persist(complete=False)

    def finalize(self) -> None:
        """Mark the artifact complete (the warm CLI's end-of-pass
        stamp; seam processes leave it incomplete by design — the
        observatory is always open for more observations)."""
        self._persist(complete=True)

    def _persist(self, complete: bool) -> None:
        from tpu_reductions_torch.utils.jsonio import atomic_json_dump
        rows = self.rows
        atomic_json_dump(self.path, {**_META, "complete": complete,
                                     "surfaces": rows})
        ledger.emit("artifact.persist", path=self.path, rows=len(rows),
                    complete=complete, grain="compile")


_armed: Optional[CompileLedger] = None
_last: Optional[dict] = None


def last_observation() -> Optional[dict]:
    """The most recent compile_span's full observation row (the warm
    CLI reads it back right after each probe; None before any span)."""
    return _last


def arm(path: Optional[str] = None) -> Optional[CompileLedger]:
    """Open (or reuse) the persistent observation store: explicit path,
    else TPU_REDUCTIONS_COMPILE_LEDGER, else whatever an entry point
    already armed this process (the span seams call `arm()` bare), else
    off (events only)."""
    global _armed
    if ledger.disabled():
        return None
    if path is None:
        path = os.environ.get(ENV_PATH) or None
        if path is None:
            return _armed
    path = os.fspath(path)
    if _armed is None or _armed.path != path:
        _armed = CompileLedger(path)
    return _armed


def disarm() -> None:
    """Drop the armed store (tests)."""
    global _armed
    _armed = None


@contextlib.contextmanager
def compile_span(surface: str, **fields):
    """Bracket one compile seam (module docstring). Yields a mutable
    dict the caller may extend (split timings such as `compile_s`);
    everything in it rides the compile.end event and the persisted row. Never raises on its own:
    the observed compile's exceptions pass through untouched, recorded
    as `error` on the end event."""
    from tpu_reductions_torch.obs import trace
    before = compile_cache.fingerprint()
    # one child trace context for the whole seam: the
    # start/end pair share a span id and nested emits parent under it,
    # so compile spans gain causal parentage in the trace tree for free
    with trace.child():
        ledger.emit("compile.start", surface=surface, **fields)
        obs: dict = {}
        t0 = time.monotonic()
        err = None
        try:
            yield obs
        except BaseException as e:
            err = f"{type(e).__name__}: {e}"[:200]
            raise
        finally:
            dur = round(time.monotonic() - t0, 6)
            after = compile_cache.fingerprint()
            verdict = compile_cache.verdict(before, after)
            row = {"surface": surface, "platform": _platform(),
                   "verdict": verdict, "dur_s": dur,
                   "cache_new": len(after - before), **fields, **obs}
            if err is not None:
                row["error"] = err
            global _last
            _last = row
            ledger.emit("compile.end", **row)
            store = arm()
            if store is not None and err is None:
                store.record({k: v for k, v in row.items()
                              if k != "cache_new"})


def load(path: str = DEFAULT_LEDGER) -> Optional[dict]:
    """The committed artifact, parsed (None when absent/foreign) — the
    read primitive CompileModel and bench/regen share."""
    try:
        data = json.loads(open(path).read())
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or not all(
            data.get(k) == v for k, v in _META.items()):
        return None
    return data


class CompileModel:
    """The scheduler-facing read model over a committed
    compile_ledger.json: which surfaces are cache-warm right now, and
    how many cold-compile seconds the cache banked (sched/priors.py
    folds this into the per-task duration estimate)."""

    def __init__(self, rows: Iterable[dict] = ()) -> None:
        self._by_surface: Dict[str, Dict[str, dict]] = {}
        for row in rows:
            if not isinstance(row, dict):
                continue
            s, v = row.get("surface"), row.get("verdict")
            if isinstance(s, str) and isinstance(v, str):
                self._by_surface.setdefault(s, {})[v] = row

    @classmethod
    def from_file(cls, path: str = DEFAULT_LEDGER,
                  platform: Optional[str] = None) -> "CompileModel":
        """Load from the committed artifact; `platform` keeps only
        rows observed on that backend (a cpu-warm surface says nothing
        about the card's) — rows without a platform stamp pass
        either way."""
        data = load(path)
        rows = (data or {}).get("surfaces", [])
        if platform is not None:
            rows = [r for r in rows if isinstance(r, dict)
                    and r.get("platform") in (platform, None)]
        return cls(rows)

    def known(self, surface: str) -> bool:
        return surface in self._by_surface

    def is_warm(self, surface: str) -> bool:
        """Warm = a warm observation exists, or a cold one does and the
        persistent cache it populated is still on disk (the cold
        compile's entries make the NEXT one warm by construction)."""
        obs = self._by_surface.get(surface)
        if not obs:
            return False
        if "warm" in obs:
            return True
        return "cold" in obs and bool(compile_cache.fingerprint())

    def _dur(self, surface: str, verdict: str) -> Optional[float]:
        row = self._by_surface.get(surface, {}).get(verdict)
        d = (row or {}).get("dur_s")
        return float(d) if isinstance(d, (int, float)) else None

    def saved_s(self, surfaces: Iterable[str]) -> float:
        """Cold-minus-warm seconds the cache banks across `surfaces`
        that are warm right now — what a task's estimate may shed."""
        total = 0.0
        for s in surfaces:
            if not self.is_warm(s):
                continue
            cold = self._dur(s, "cold")
            if cold is None:
                continue
            total += max(cold - (self._dur(s, "warm") or 0.0), 0.0)
        return total

    def status(self, surfaces: Iterable[str]) -> str:
        """One word for the plan table's cold/warm column: 'warm'
        (every known surface warm), 'cold' (none warm), 'mixed', or
        '-' (no surfaces declared / nothing observed)."""
        surfaces = list(surfaces)
        if not surfaces:
            return "-"
        known = [s for s in surfaces if self.known(s)]
        if not known:
            return "-"
        warm = [self.is_warm(s) for s in known]
        if all(warm) and len(known) == len(surfaces):
            return "warm"
        return "mixed" if any(warm) else "cold"


def compile_markdown(data: dict) -> str:
    """The per-surface cold/warm compile-latency table for report.md
    (bench/regen.py folds it next to the GB/s tables) — pure formatting
    over the committed artifact."""
    rows = [r for r in data.get("surfaces", []) if isinstance(r, dict)]
    lines = ["## compile observatory (per-surface cold/warm)", "",
             "| surface | platform | verdict | lower s | compile s "
             "| total s | obs |",
             "|---|---|---|---|---|---|---|"]
    if not rows:
        lines.append("| (no observations) | - | - | - | - | - | - |")
    for r in rows:
        def _f(key):
            v = r.get(key)
            return f"{v:.3f}" if isinstance(v, (int, float)) else "-"
        lines.append(
            f"| {r.get('surface', '?')} | {r.get('platform') or '-'} "
            f"| {r.get('verdict', '?')} | {_f('lower_s')} "
            f"| {_f('compile_s')} | {_f('dur_s')} "
            f"| {r.get('count', 1)} |")
    state = "complete" if data.get("complete") else "open"
    lines.append("")
    lines.append(f"observatory: {state}; cold surfaces re-pay their "
                 "compile next window, warm ones serve from "
                 "the build directory")
    return "\n".join(lines)
