"""Checkpoint and resume of a race's or a stream's `--out` artifact.

The counterpart of tpu_reductions/bench/resume.py:1, with its ledger
events (`resume.decision`, `resume.reuse`, `artifact.persist`):
`Checkpoint` (one artifact `{**meta, "complete": bool,
<rows_key>: [...]}`, written atomically after every row; a re-invocation
against an artifact left `complete: false` by an interrupted run reuses
its rows instead of measuring them again), `default_reusable`,
`prior_artifact` (the same rule for a one-row artifact),
`run_checkpointed_cells` (the grid instruments' loop) and
`result_from_row`; and the experiment sweep's per-cell cache files
(`load_cell`, `store_cell`). A
`complete: true` artifact is a finished run: running again measures
afresh, since resume is interruption-proofing, not a cache.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Callable, List, Optional

from tpu_reductions_torch.bench.driver import BenchResult
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils.jsonio import atomic_json_dump
from tpu_reductions_torch.utils.qa import QAStatus


def default_reusable(row: dict) -> bool:
    """A persisted row may stand in for a measurement when it is verified
    or waived by design (smoke manifests spell that `ok`); FAILED rows,
    and rows with no verdict, run again.
    The counterpart of tpu_reductions/bench/resume.py:43."""
    if row.get("ok") is True:
        return True
    return row.get("status") in ("PASSED", "WAIVED")


def prior_artifact(path: Optional[str | os.PathLike],
                   meta: dict) -> Optional[dict]:
    """The artifact an interrupted run left at `path`, parsed, or None:
    it must exist, parse, be marked `complete: false`, and hold every
    meta key as given (Checkpoint's rule, for a one-row artifact such as
    bench/firstrow.py's).
    The counterpart of tpu_reductions/bench/resume.py:57."""
    if path is None or not os.path.exists(path):
        return None
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None   # unreadable: measure again
    if not isinstance(data, dict) or data.get("complete") is True:
        return None
    meta = json.loads(json.dumps(meta))
    if not all(data.get(k) == v for k, v in meta.items()):
        return None
    ledger.emit("resume.decision", mode="resume-single",
                path=os.fspath(path))
    return data


class Checkpoint:
    """Atomic, idempotent row persistence behind one `--out` artifact.
    The counterpart of tpu_reductions/bench/resume.py:83."""

    def __init__(self, path: Optional[str | os.PathLike], meta: dict, *,
                 key_fn: Callable[[dict], object],
                 rows_key: str = "rows",
                 sort_key: Optional[Callable[[dict], object]] = None):
        """`path` None keeps everything in memory. `meta` is the
        invocation contract: prior rows are reused only when every meta
        key round-trips identically through the prior artifact. `key_fn`
        maps a row to its identity; `sort_key`, when given, orders the
        rows at every persist."""
        self.path = os.fspath(path) if path is not None else None
        # a JSON round trip, so tuple-valued meta compares equal to the
        # lists it becomes on disk
        self.meta = json.loads(json.dumps(meta))
        self.rows_key = rows_key
        self._sort_key = sort_key
        self.rows: List[dict] = []
        self._prior = {}
        prior = self._load_prior()
        if (prior is not None and prior.get("complete") is not True
                and all(prior.get(k) == v for k, v in self.meta.items())):
            for row in prior.get(rows_key, []):
                if isinstance(row, dict):
                    self._prior[key_fn(row)] = row
        if self.path is not None:
            ledger.emit("resume.decision",
                        mode="resume" if self._prior else "fresh",
                        path=self.path, prior_rows=len(self._prior))

    def _load_prior(self) -> Optional[dict]:
        if self.path is None or not os.path.exists(self.path):
            return None
        try:
            data = json.loads(Path(self.path).read_text())
        except (OSError, ValueError):
            return None   # unreadable: measure again
        return data if isinstance(data, dict) else None

    def resume(self, key: object,
               reusable: Callable[[dict], bool] = default_reusable
               ) -> Optional[dict]:
        """The prior run's row for `key`, if there is one and `reusable`
        accepts it; the caller skips the measurement and `add()`s the row
        unchanged.
        The counterpart of tpu_reductions/bench/resume.py:139."""
        row = self._prior.get(key)
        if row is not None and reusable(row):
            ledger.emit("resume.reuse", key=str(key), path=self.path)
            return row
        return None

    def add(self, row: dict, extra: Optional[dict] = None) -> None:
        """Append one row and persist the artifact as incomplete.
        The counterpart of tpu_reductions/bench/resume.py:158."""
        self.rows.append(row)
        self._persist(complete=False, extra=extra)

    def finalize(self, extra: Optional[dict] = None) -> None:
        """Mark the artifact complete.
        The counterpart of tpu_reductions/bench/resume.py:168."""
        self._persist(complete=True, extra=extra)

    def _persist(self, complete: bool, extra: Optional[dict]) -> None:
        if self.path is None:
            return
        rows = (sorted(self.rows, key=self._sort_key)
                if self._sort_key else self.rows)
        atomic_json_dump(self.path, {**self.meta, **(extra or {}),
                                     "complete": complete,
                                     self.rows_key: rows})
        ledger.emit("artifact.persist", path=self.path, rows=len(rows),
                    complete=complete)


def run_checkpointed_cells(ck: Checkpoint, cells, measure,
                           on_row=None) -> List[dict]:
    """The per-cell resume loop of a grid instrument: for each cell key,
    the prior run's row when the Checkpoint takes it, else
    `measure(key)`; either way `add()`ed, then `on_row(key, row)`; the
    artifact is finalized once the grid is done. A `measure` that returns
    None (a process outside the cell's mesh, across cards) adds no row.
    Returns the rows in grid order.
    The counterpart of tpu_reductions/bench/resume.py:191."""
    rows: List[dict] = []
    for key in cells:
        row = ck.resume(key)
        if row is None:
            row = measure(key)
        if row is None:
            continue
        ck.add(row)
        if on_row is not None:
            on_row(key, row)
        rows.append(row)
    ck.finalize()
    return rows


def load_cell(path: str | os.PathLike) -> dict:
    """One sweep-grid cell file as a dict; {} when it is absent, truncated
    or not an object, so the caller measures the cell again (the read
    half of sweep_all's resume, shared with seed_cache).
    The counterpart of tpu_reductions/bench/resume.py:218."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def store_cell(path: str | os.PathLike, row: dict) -> None:
    """Persist one sweep-grid cell atomically, as one compact JSON line
    (the write half of sweep_all's resume and of seed_cache).
    The counterpart of tpu_reductions/bench/resume.py:232."""
    atomic_json_dump(path, row, indent=None)
    ledger.emit("artifact.persist", path=os.fspath(path), rows=1,
                complete=True, grain="cell")


def result_from_row(cfg, row: dict) -> BenchResult:
    """A BenchResult from a persisted row, so that resumed candidates rank
    beside fresh ones. Only what ranking and reporting read (gbps, status,
    identity) is real; the oracle fields are nan, since the row was
    verified when it was measured.
    The counterpart of tpu_reductions/bench/resume.py:245."""
    gbps = row.get("gbps")
    gbps = (float(gbps) if isinstance(gbps, (int, float))
            and math.isfinite(gbps) else 0.0)
    nan = float("nan")
    return BenchResult(cfg.method, cfg.dtype, cfg.n, cfg.backend,
                       cfg.kernel, gbps, 0.0, cfg.iterations,
                       QAStatus[row.get("status", "FAILED")], nan, nan, nan,
                       waived_reason=row.get("waived_reason"),
                       timing=row.get("timing"))
