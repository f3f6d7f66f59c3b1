"""The port lint's concurrency layer — thread roots, guarded-by
inference, lock-order and stall-amplifier rules (RED021-RED024), carried
over from tpu_reductions/lint/conc/ unchanged in substance.

Two halves, riding the flow layer's machinery (lint/flow/):

* `extract` — one pure AST pass per file (cached next to the call-graph
  extraction in the fact cache) collecting lock definitions,
  thread/timer/executor spawn sites, lock acquisitions with lexical
  extents, shared-state writes, blocking calls and joins;
* `analysis` — the interprocedural pass over the linked call graph:
  thread-root discovery, a held-locks fixpoint (must- and may- sets),
  and the four rules RED021 (unguarded shared write), RED022
  (lock-order inversion), RED023 (blocking call / device sync while
  holding a lock — the static exit-4 stall amplifier) and RED024
  (leaked non-daemon thread).

This module imports nothing (see lint/flow/__init__.py).
"""
