"""Deterministic payload generation, bit-identical to the JAX package's.

numpy's MT19937 with the same seed words and rank offset as
tpu_reductions/utils/rng.py, so a given (n, dtype, rank, seed) yields the
same bits in both packages: ints uniform in [0, 255], reals that byte over
glibc's RAND_MAX (the reference's `rand() & 0xFF` scheme). bfloat16 is
rounded from float64 by torch, which gives the same bits as numpy's
`astype(bfloat16)` on every value of this payload.
"""

from __future__ import annotations

import numpy as np
import torch

_BASE_SEED_WORDS = (0x1571, 0x2662, 0x3753, 0x4844)


def _mt_for_rank(rank: int, seed: int = 0) -> np.random.Generator:
    words = (_BASE_SEED_WORDS[0] + rank + seed,) + _BASE_SEED_WORDS[1:]
    return np.random.Generator(np.random.MT19937(list(words)))


def host_data(n: int, dtype: str, rank: int = 0, seed: int = 0
              ) -> torch.Tensor:
    """The benchmark payload of one rank, as a CPU tensor of `dtype`
    (a config dtype name)."""
    g = _mt_for_rank(rank, seed)
    bytes_ = g.integers(0, 256, size=n, dtype=np.int64)
    if dtype == "int32":
        return torch.from_numpy(bytes_.astype(np.int32))
    reals = bytes_ / float(2**31 - 1)  # glibc RAND_MAX
    if dtype == "bfloat16":
        return torch.from_numpy(reals).to(torch.bfloat16)
    return torch.from_numpy(reals.astype(dtype))
