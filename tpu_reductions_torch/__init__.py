"""PyTorch + CUDA port of tpu_reductions: the self-verifying single-GPU
reduction benchmark, with its TPU kernels rewritten by hand for Hopper
(csrc/). It imports torch and numpy, never jax or tpu_reductions.

  python -m tpu_reductions_torch --method=SUM --type=int [--platform=cpu]
"""
