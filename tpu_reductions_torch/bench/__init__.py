"""The port's benchmark drivers, sweeps, experiments and reports: the
counterpart of tpu_reductions/bench/__init__.py:1."""
