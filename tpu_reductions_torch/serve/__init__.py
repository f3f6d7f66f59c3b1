"""Reduction as a service on one card: the serving path and the replica
fleet.

The counterpart of tpu_reductions/serve/ (docs/PORT.md "Serving on one
card" and "The fleet on one card"):

  request.py    the typed request and response, and the future-like slot
  transport.py  the per-launch gate: the null gate on a local card, the
                relay gate for a modeled round trip
  coalesce.py   batch formation, round planning, the online cost model
  engine.py     admission -> queue -> coalesce -> plan -> launch ->
                verify -> respond (no device call)
  executor.py   the serving path's only module that touches the device,
                the shard route and the drain's reshard included
  router.py     the replica router, local and process replicas, fleet
                adoption (`python -m tpu_reductions_torch.serve.router`)
  journal.py    the write-ahead fleet journal
  autoscale.py  the autoscaler and the drain
  loadgen.py    the load generator: the closed loop, and the fleet's
                --scale, --elastic and --recovery
  __main__.py   `python -m tpu_reductions_torch.serve`, the TCP JSON-lines
                front end

Every request transition is a `serve.*` ledger event (obs/ledger.py); the
fleet's are `route.*`, `replica.*`, `journal.*`, `adopt.*`, `drain.*` and
`autoscale.*`.
"""

from tpu_reductions_torch.serve.request import (ReduceRequest,
                                                ReduceResponse,
                                                TransportDead)

__all__ = ["ReduceRequest", "ReduceResponse", "TransportDead"]
