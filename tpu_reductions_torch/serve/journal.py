"""The write-ahead fleet journal: the control plane's crash consistency.

The counterpart of tpu_reductions/serve/journal.py, key for key: a
journal written by either package replays in the other. The fleet's
state (which `ProcessReplica` children exist with their name, port, pid,
platform, relay port and lifecycle state; which bucket placements were
prewarmed where; where the autoscaler's control loop stands) is persisted
atomically (utils/jsonio) before the action it describes, under a meta
contract, so that a restarted `python -m tpu_reductions_torch.serve.router
--journal=PATH` re-adopts the children that still serve, reaps the rest
INT first, and resumes the autoscaler mid-cooldown.

Write-ahead order: `record_replica(name, state="starting")` lands before
the spawn; "up" with port and pid the moment the port file resolves; the
drain's phases before each acts. A crash between journal and action
leaves a conservative record: recovery probes a "starting" entry and
forgets it, instead of meeting an unrecorded orphan.

On the card every journaled child holds a CUDA context of its own, so an
orphan the journal does not name keeps a share of the card's memory
until it is found by hand: the journal is what lets a successor find and
reap it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils.jsonio import atomic_json_dump

# the meta contract: a file whose meta does not round-trip is some other
# instrument's, and is not replayed
JOURNAL_META = {"instrument": "fleet_journal", "version": 1}

# a journaled replica is in exactly one of these states:
#   starting   journaled ahead of the spawn; no port or pid yet
#   up         serving (port and pid recorded)
#   draining   planned scale-down in progress (admission closed)
#   down       removed from the fleet (a tombstone until forgotten)
REPLICA_STATES = ("starting", "up", "draining", "down")


class FleetJournal:
    """Atomically persisted fleet state (module docstring). With
    `path=None` it is an in-memory record: in-process fleets keep the
    same call sites without touching disk. Thread-safe: submit threads,
    the autoscaler loop and drain workers record through one lock."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = os.fspath(path) if path else None
        self._lock = threading.Lock()
        self._replicas: Dict[str, dict] = {}
        self._placements: List[list] = []
        self._autoscaler: Optional[dict] = None
        replayed = self._load()
        if self.path:
            ledger.emit("journal.open", path=self.path,
                        replayed=replayed,
                        replicas=len(self._replicas))

    # -- load / persist ------------------------------------------------

    def _load(self) -> bool:
        """Replay an existing file when the meta contract allows; a
        truncated or foreign file is ignored (an empty fleet record is
        the conservative posture)."""
        if not self.path or not os.path.exists(self.path):
            return False
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False
        if not isinstance(data, dict):
            return False
        if any(data.get(k) != v for k, v in JOURNAL_META.items()):
            return False
        reps = data.get("replicas")
        self._replicas = {str(k): dict(v) for k, v in reps.items()} \
            if isinstance(reps, dict) else {}
        self._placements = [list(p) for p in data.get("placements", [])
                            if isinstance(p, (list, tuple))]
        auto = data.get("autoscaler")
        self._autoscaler = dict(auto) if isinstance(auto, dict) else None
        ledger.emit("journal.replay", path=self.path,
                    replicas=len(self._replicas),
                    placements=len(self._placements),
                    autoscaler=self._autoscaler is not None)
        return True

    def _persist_locked(self, kind: str, name: Optional[str]) -> None:
        if not self.path:
            return
        atomic_json_dump(self.path, {
            **JOURNAL_META,
            "wall": time.time(),
            "replicas": self._replicas,
            "placements": self._placements,
            "autoscaler": self._autoscaler,
        })
        ledger.emit("journal.record", kind=kind,
                    **({"name": name} if name else {}),
                    replicas=len(self._replicas))

    # -- replica transitions (write-ahead: call before acting) ---------

    def record_replica(self, name: str, *, state: str,
                       port: Optional[int] = None,
                       pid: Optional[int] = None,
                       platform: Optional[str] = None,
                       relay_port: Optional[int] = None) -> None:
        """Journal one replica transition. Fields given as None keep their
        journaled value (a drain does not forget the port that adoption
        probes)."""
        if state not in REPLICA_STATES:
            raise ValueError(f"state must be one of {REPLICA_STATES}, "
                             f"got {state!r}")
        with self._lock:
            entry = dict(self._replicas.get(name) or {})
            entry["state"] = state
            for key, val in (("port", port), ("pid", pid),
                             ("platform", platform),
                             ("relay_port", relay_port)):
                if val is not None:
                    entry[key] = val
            self._replicas[name] = entry
            self._persist_locked(f"replica-{state}", name)

    def forget_replica(self, name: str) -> None:
        """Drop an entry (a recovery explained it, or a spawn failed
        before the child existed)."""
        with self._lock:
            if self._replicas.pop(name, None) is not None:
                self._persist_locked("replica-forget", name)

    # -- placements / autoscaler ---------------------------------------

    def record_placement(self, method: str, dtype: str, n: int) -> None:
        """Journal one prewarmed bucket placement: what recovery
        re-prewarms onto the adopted fleet."""
        key = [method, dtype, int(n)]
        with self._lock:
            if key in self._placements:
                return
            self._placements.append(key)
            self._persist_locked("placement", None)

    def record_autoscaler(self, state: Optional[dict]) -> None:
        """Journal the autoscaler's exported control-loop state
        (serve/autoscale.Autoscaler.export_state)."""
        with self._lock:
            self._autoscaler = dict(state) if state else None
            self._persist_locked("autoscaler", None)

    # -- recovery-side accessors ---------------------------------------

    def replicas(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._replicas.items()}

    def placements(self) -> List[tuple]:
        with self._lock:
            return [tuple(p) for p in self._placements]

    def autoscaler_state(self) -> Optional[dict]:
        with self._lock:
            return dict(self._autoscaler) if self._autoscaler else None
