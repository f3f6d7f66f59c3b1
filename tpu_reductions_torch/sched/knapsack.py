"""Greedy value/expected-cost ranking: the one knapsack core.

The counterpart of tpu_reductions/sched/knapsack.py. The serving engine
ranks coalesced batches by value per expected device-second against a
per-round device-time window (serve/coalesce.plan_round). Pure: no
clocks, no I/O, no device. `fits` is advisory: the caller launches the
top entry whatever it says.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Sequence

# floor of a cost estimate in the ratio
_MIN_COST = 1e-9


@dataclass(frozen=True)
class Ranked:
    """One planned pick with the estimates that ranked it."""
    item: object
    cost: float           # expected cost in seconds
    ratio: float          # value / cost, the greedy key
    fits: bool            # inside the cumulative budget
    cumulative: float     # running cost up to and including this


def rank_order(items: Iterable, *, value: Callable[[object], float],
               cost: Callable[[object], float],
               tie_key: Callable[[object], object] = str) -> List:
    """Order one pool by descending value/cost (then value, then
    tie_key)."""
    return sorted(items,
                  key=lambda it: (-value(it) / max(cost(it), _MIN_COST),
                                  -value(it), tie_key(it)))


def mark_fits(ordered: Sequence, *, value: Callable[[object], float],
              cost: Callable[[object], float],
              budget_s: float) -> List[Ranked]:
    """Annotate an ordered sequence with its cumulative cost and the fits
    flag against one budget."""
    out: List[Ranked] = []
    cum = 0.0
    for it in ordered:
        c = cost(it)
        cum += c
        out.append(Ranked(item=it, cost=c,
                          ratio=value(it) / max(c, _MIN_COST),
                          fits=cum <= budget_s, cumulative=cum))
    return out


def greedy_plan(pools: Sequence[Iterable], *,
                value: Callable[[object], float],
                cost: Callable[[object], float],
                budget_s: float,
                tie_key: Callable[[object], object] = str
                ) -> List[Ranked]:
    """Rank each pool by value/cost, concatenate the pools in order, and
    mark fits against one cumulative budget."""
    ordered = [it for pool in pools
               for it in rank_order(pool, value=value, cost=cost,
                                    tie_key=tie_key)]
    return mark_fits(ordered, value=value, cost=cost, budget_s=budget_s)
