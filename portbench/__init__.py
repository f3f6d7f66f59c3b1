"""The benchmark of tpu_reductions_torch, the PyTorch and CUDA port.

  python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once on the card and prints its result as
the last line of standard output (README.md). It measures the port only:
no module it loads is jax, jaxlib, flax or the JAX package.
"""
