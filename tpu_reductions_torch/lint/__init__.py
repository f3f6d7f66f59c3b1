"""The port lint: a static pass over the port's own sources, the
counterpart of the JAX package's redlint (tpu_reductions/lint/).

It holds the port to its rules before any card time is spent: measured
times come from the timing homes, host->device copies go through the
stager, an entry point arms the watchdog before its first dispatch,
serve/ launches only through serve/executor.py, shared state is written
under its lock, and every machine-parsed row comes from lint/grammar.py.

    python -m tpu_reductions_torch.lint [paths] [--format=text|json]
        [--no-flow] [--changed-only] [--flow-cache=FILE]
        [--graph=dot|json] [--fix-docstrings] [--fix-stale-waivers]

docs/PORT.md ("The lint on the port") lists the rules. A waiver is a
comment on the line or alone on the line above:
`# redlint: disable=RED0NN -- reason`.

The package imports neither torch nor jax. This module imports nothing:
utils/qa.py imports lint.grammar on every CLI start, and that must not
load the engine, the rules or the flow layer.
"""
