"""Reduction as a service on one card: the single-engine serving path.

The counterpart of tpu_reductions/serve/ (docs/PORT.md "Serving on one
card"):

  request.py    the typed request and response, and the future-like slot
  transport.py  the per-launch gate; on a local card the null gate
  coalesce.py   batch formation, round planning, the online cost model
  engine.py     admission -> queue -> coalesce -> plan -> launch ->
                verify -> respond (no device call)
  executor.py   the serving path's only module that touches the device
  loadgen.py    the closed-loop load generator and the seeded open-loop
                primitives
  __main__.py   `python -m tpu_reductions_torch.serve`, the TCP JSON-lines
                front end

Every request transition is a `serve.*` ledger event (obs/ledger.py). The
replica router, the process replicas, the journal and the autoscaler
are ROADMAP Queue A item 8b.
"""

from tpu_reductions_torch.serve.request import (ReduceRequest,
                                                ReduceResponse,
                                                TransportDead)

__all__ = ["ReduceRequest", "ReduceResponse", "TransportDead"]
