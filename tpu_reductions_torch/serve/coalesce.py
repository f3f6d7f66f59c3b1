"""Batch formation, round planning and the online duration cost model.

The counterpart of tpu_reductions/serve/coalesce.py. Requests coalesce
when they share (method, dtype, n): one stacked (k, n) launch computes
all k results (serve/executor.py). A batch is bounded by `max_batch` rows
and by `max_batch_bytes` of stacked payload. Rounds are planned with the
knapsack (sched/knapsack.py): a batch's value is the sum of its
requests', its cost the `CostModel`'s expected seconds for its key, the
budget the engine's device window; the top pick always launches.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from tpu_reductions_torch.sched.knapsack import greedy_plan

BatchKey = Tuple[str, str, int]          # (method, dtype, n)

_batch_ids = itertools.count()


@dataclass
class Batch:
    """One launch: compatible admitted requests in arrival order (each
    item carries .request and .request_id; serve/engine.py)."""

    key: BatchKey
    admitted: List = field(default_factory=list)
    batch_id: str = field(
        default_factory=lambda: f"b{next(_batch_ids):05d}")

    @property
    def size(self) -> int:
        return len(self.admitted)

    @property
    def value(self) -> float:
        return sum(a.request.value for a in self.admitted)

    @property
    def nbytes(self) -> int:
        return sum(a.request.nbytes for a in self.admitted)


def coalesce(admitted: Sequence, *, max_batch: int,
             max_batch_bytes: int) -> List[Batch]:
    """Group admitted requests by key in arrival order, splitting at the
    row and byte bounds."""
    by_key: Dict[BatchKey, List] = {}
    order: List[BatchKey] = []
    for a in admitted:
        r = a.request
        key = (r.method, r.dtype, r.n)
        if key not in by_key:
            by_key[key] = []
            order.append(key)
        by_key[key].append(a)
    batches: List[Batch] = []
    for key in order:
        cur = Batch(key=key)
        for a in by_key[key]:
            if cur.size >= max_batch or \
                    (cur.size and cur.nbytes + a.request.nbytes
                     > max_batch_bytes):
                batches.append(cur)
                cur = Batch(key=key)
            cur.admitted.append(a)
        if cur.size:
            batches.append(cur)
    return batches


class CostModel:
    """Exponentially weighted expected seconds per batch key; `default_s`
    is the prior of an unseen key."""

    def __init__(self, *, alpha: float = 0.3,
                 default_s: float = 0.02) -> None:
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self._alpha = alpha
        self._default_s = default_s
        self._est: Dict[BatchKey, float] = {}

    def estimate(self, key: BatchKey) -> float:
        return self._est.get(key, self._default_s)

    def observe(self, key: BatchKey, seconds: float) -> None:
        if seconds <= 0:
            return
        prev = self._est.get(key)
        self._est[key] = seconds if prev is None else \
            (1 - self._alpha) * prev + self._alpha * seconds


def plan_round(batches: Sequence[Batch], *, cost_model: CostModel,
               device_window_s: float
               ) -> Tuple[List[Batch], List[Batch]]:
    """One round: (launch_now, defer); the top pick always launches."""
    if not batches:
        return [], []
    ranked = greedy_plan([batches],
                         value=lambda b: b.value,
                         cost=lambda b: cost_model.estimate(b.key),
                         budget_s=device_window_s,
                         tie_key=lambda b: b.batch_id)
    launch = [r.item for r in ranked if r.fits]
    if not launch:
        launch = [ranked[0].item]
    chosen = {id(b) for b in launch}
    defer = [r.item for r in ranked if id(r.item) not in chosen]
    return launch, defer
