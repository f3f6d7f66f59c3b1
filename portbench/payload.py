"""The benchmark's payloads, drawn on the device from the seed.

The value ranges are those of the reference's data (the port's
utils/rng.host_data, copied here as ranges, not as code): int32 uniform
in [0, 255] (`rand() & 0xFF`), float64 that byte over 2^31 - 1 (glibc's
RAND_MAX). Each payload is its own stream: (seed, stream) seeds one
torch.Generator on the device, so the same seed gives the same payloads,
and a block can be drawn again alone (the collective's reference draws
each rank's block in turn).
"""

from __future__ import annotations

import torch

DTYPES = {"int32": torch.int32, "float64": torch.float64}
RAND_MAX = 2**31 - 1
STREAMS = 1 << 12      # streams a seed owns: payloads, or ranks by dtype


def stream_seed(seed: int, stream: int) -> int:
    """The generator seed of one stream of `seed` (any integer)."""
    if not 0 <= stream < STREAMS:
        raise ValueError(f"stream {stream} outside [0, {STREAMS})")
    return (seed % (1 << 48)) * STREAMS + stream


def draw(seed: int, stream: int, n: int, dtype: str,
         device: torch.device) -> torch.Tensor:
    """n elements of `dtype` on `device`, from (seed, stream)."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    x = torch.empty(n, dtype=DTYPES[dtype], device=device)
    x.random_(0, 256, generator=g)
    if dtype == "float64":
        x.div_(RAND_MAX)
    return x


def stream_of(dtype: str, index: int) -> int:
    """The stream of payload (or rank) `index` of a dtype."""
    return list(DTYPES).index(dtype) * (STREAMS // 2) + index
