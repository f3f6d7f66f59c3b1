"""The quantized wire's constants and support predicates.

The port's own copy of what the algorithm registry (collectives/
algorithms.py) and the collective config read from the JAX package's
collectives/quant.py: the block and bit widths, the dtypes each quantized
path covers, and the gates `quant_supported` and `quant_ring_applies`.
The quantized constructors themselves (the block-scaled SUM rings, the coarse
order-key MIN/MAX) are not ported yet (ROADMAP item 6b); the collective
driver refuses --quantized.
"""

from __future__ import annotations

QUANT_BLOCK = 256   # elements per quantization block (one f32 scale each)
Q8_BLOCK = QUANT_BLOCK      # the original int8 ring's name

QUANT_BITS = (4, 8, 16)         # SUM wire widths (block-scaled ints)
KEY_BITS = (8, 16)              # MIN/MAX coarse-key widths

# the dtypes each quantized path covers; ints have no lossy story
SUM_DTYPES = ("float32", "bfloat16", "float64")
MINMAX_DTYPES = ("float32", "float64")


def levels(bits: int) -> int:
    """Symmetric quantization levels per side: 7 / 127 / 32767."""
    return (1 << (bits - 1)) - 1


def quant_supported(method: str, dtype: str, bits: int = 8) -> bool:
    """Whether a --quantized (method, dtype, bits) combination has a
    declared algorithm and error story (SUM: bounded; MIN/MAX: exact)."""
    method = method.upper()
    if method == "SUM":
        return dtype in SUM_DTYPES and bits in QUANT_BITS
    if method in ("MIN", "MAX"):
        return dtype in MINMAX_DTYPES and bits in KEY_BITS
    return False


def quant_support_error(method: str, dtype: str, bits: int = 8) -> str:
    """The message for an unsupported --quantized combination, naming
    what is supported (the JAX package's words)."""
    return (f"--quantized does not support {method.upper()} over "
            f"{dtype} at {bits} bits. Supported: SUM over "
            f"float/bfloat16/double at --quant-bits 4/8/16 (block-"
            f"scaled int ring with error feedback, bounded error — "
            f"docs/COLLECTIVES.md); MIN/MAX over float/double at "
            f"--quant-bits 8/16 (order-preserving quantized keys, "
            f"EXACT). Integer dtypes have no lossy story — drop "
            f"--quantized for the exact collectives.")


def quant_ring_applies(k: int, per_rank: int, bits: int = 8) -> bool:
    """Whether the quantized ring runs for this geometry: k > 1 and
    per-rank chunks block-aligned (per_rank divides by k*QUANT_BLOCK)."""
    return k > 1 and per_rank % (k * QUANT_BLOCK) == 0
