"""The port's reduction ops: the op registry, the hand-written kernels and
their wrappers, the chain, the stream and the host oracle: the
counterpart of tpu_reductions/ops/__init__.py:1."""
