"""The port lint's whole-program layer — call graph + device-flow
dataflow (the counterpart of tpu_reductions/lint/flow/).

The per-file rules (lint/rules.py) fence *spellings*: RED011 sees a
device touch only inside a ``bench/`` entry point's ``main``, RED014 only
inside ``serve/``, RED015/RED016 only match literal call chains. A helper
that touches the card two frames below an ungated CLI passes those
fences clean. This package closes that hole: it resolves a static call
graph over every linted module (callgraph.py), seeds per-function
*facts* — TOUCHES_DEVICE, DISPATCH, SYNC, GATES, GUARDS, RETRIES, STAGES,
INGESTS, WALLCLOCK (facts.py) — and propagates them to a fixpoint
(dataflow.py), so "device-reachable" and "gated on every path" are
computed properties of a function, not of a file pattern.

Rules RED017-RED020 are evaluated on the propagated graph; findings flow
through the same engine/waiver machinery as the per-file rules.
`dataflow.analyze_flow` is the engine's entry; `build_cached_project` /
`export_graph` back the CLI's --graph output. This module imports
nothing, so that importing one submodule never runs another
half-initialized.
"""
