"""The execution core: one executor for every launch.

The counterpart of tpu_reductions/exec/:

* `plan.py`  the frozen `LaunchPlan` (surface, builder, geometry, timing,
  resilience contract); producers build plans, `core.run` consumes them;
* `core.py`  the one executor: the heartbeat guards, the retry
  classification, the compile-seam spans and the `exec.plan` /
  `exec.launch` / `exec.done` events;
* `cost.py`  the cost oracle: kernel, topology, wire and scan picks from
  the port's own evidence under `out/`, each an `exec.select` event.

`python -m tpu_reductions_torch.exec --explain` prints the decision table.
"""

from tpu_reductions_torch.exec.plan import LaunchPlan, ResilienceContract

__all__ = ["LaunchPlan", "ResilienceContract"]
