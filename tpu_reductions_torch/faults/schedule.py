"""Fault-schedule parsing (the counterpart of tpu_reductions/faults/
schedule.py): a JSON list of relay phases stepped through in order,

    [{"behavior": "accept", "duration_s": 2},
     {"behavior": "refuse", "connections": 3},
     {"behavior": "accept"}]

with `behavior` one of accept / refuse / stall / slow, `delay_s` the hold
of a slow phase (default 0.25 s), and at most one of `duration_s` and
`connections` to advance on. The chaos relay (faults/relay.py) steps
through it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Sequence, Union

BEHAVIORS = ("accept", "refuse", "stall", "slow")

DEFAULT_SLOW_DELAY_S = 0.25


@dataclasses.dataclass(frozen=True)
class Phase:
    """One relay behaviour interval of a fault schedule."""

    behavior: str
    duration_s: float | None = None
    connections: int | None = None
    delay_s: float | None = None

    def __post_init__(self):
        if self.behavior not in BEHAVIORS:
            raise ValueError(f"unknown behavior {self.behavior!r} "
                             f"(expected one of {BEHAVIORS})")
        if self.duration_s is not None and self.connections is not None:
            raise ValueError("a phase advances on duration_s OR "
                             "connections, not both")
        if self.behavior == "refuse" and self.connections is not None:
            raise ValueError("refused connects never reach userspace: a "
                             "'refuse' phase must advance on duration_s")
        if self.duration_s is not None and self.duration_s < 0:
            raise ValueError(f"duration_s must be >= 0, got "
                             f"{self.duration_s}")
        if self.connections is not None and self.connections <= 0:
            raise ValueError(f"connections must be > 0, got "
                             f"{self.connections}")
        if self.delay_s is not None and self.behavior != "slow":
            raise ValueError("delay_s is the 'slow' behavior's knob; a "
                             f"'{self.behavior}' phase must not set it")
        if self.delay_s is not None and self.delay_s <= 0:
            raise ValueError(f"delay_s must be > 0, got {self.delay_s}")

    @property
    def hold_s(self) -> float:
        """The per-connection hold of a slow phase."""
        return self.delay_s if self.delay_s is not None \
            else DEFAULT_SLOW_DELAY_S


def load_schedule(src: Union[str, os.PathLike, Sequence]) -> List[Phase]:
    """Parse a schedule from a JSON file path, a JSON string, or a list of
    phase dicts or Phases; anything malformed raises ValueError."""
    if isinstance(src, (str, os.PathLike)) and os.path.exists(src):
        with open(src) as f:
            src = json.load(f)
    elif isinstance(src, str):
        src = json.loads(src)
    if not isinstance(src, (list, tuple)) or not src:
        raise ValueError("a fault schedule is a non-empty JSON list of "
                         "phases")
    phases = []
    for i, p in enumerate(src):
        if isinstance(p, Phase):
            phases.append(p)
            continue
        if not isinstance(p, dict):
            raise ValueError(f"phase {i}: expected an object, got "
                             f"{type(p).__name__}")
        unknown = set(p) - {"behavior", "duration_s", "connections",
                            "delay_s"}
        if unknown:
            raise ValueError(f"phase {i}: unknown key(s) "
                             f"{sorted(unknown)}")
        try:
            phases.append(Phase(**p))
        except (TypeError, ValueError) as e:
            raise ValueError(f"phase {i}: {e}") from e
    return phases
