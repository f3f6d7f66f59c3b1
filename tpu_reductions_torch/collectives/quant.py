"""Block-scaled quantization for the collective wire: the EQuARX idea
(arXiv:2506.17615) over a bits axis, on the port's rank axis.

The counterpart of tpu_reductions/collectives/quant.py:

  * SUM over float32, bfloat16 and the f64 dd planes at a 4/8/16-bit
    block-quantized ring wire (`make_quant_sum_all_reduce`), with
    error-feedback residuals carried from hop to hop, so that a hop's
    rounding is paid back by the next chunk this rank encodes;
  * MIN/MAX over float32/float64 on order-preserving quantized keys
    (`make_quant_key_minmax_all_reduce`): a coarse b-bit key phase, then
    exact resolve phases among the coarse ties, so the result is exact
    at every bit width.

Every wire format has a declared per-element error bound
(`quant_error_bound`, the JAX package's terms) that the driver and the
curve hold their measurements to, and a declared wire factor in
collectives/algorithms.py, both from the constants below.

On the rank axis (parallel/mesh.py) the error-feedback residual is
(k_local, c) state, one row per rank; the carriers are int8, int16 or
packed uint8 tensors, and a hop moves them and their f32 scales (inside
the card, or over gloo between processes, which carries them
byte for byte). float64 runs on the dd planes everywhere, the card
included, so that the card runs the JAX package's wire encoding. The
constructors decide the fallback and the sentinels from shapes, so a
chained collective captures into a CUDA graph without a host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_reductions_torch.collectives.rings import ring_rs_ag_stateful

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


def quant_error_bound(method: str, dtype: str, bits: int, k: int,
                      max_abs: float, error_feedback: bool = True
                      ) -> float:
    """Declared per-element |quantized - oracle| bound for a k-rank
    quantized collective over a payload with max|x| = max_abs.

    SUM: each of the k-1 scatter hops and the one gather encode rounds
    at most half a quantization step of a partial whose block max is
    <= k*max_abs: k * (k*max_abs/levels). Error feedback can at worst
    double one chunk's step budget: a 2x margin. bfloat16 adds the
    output cast's half-ulp (2^-8 relative at the summed magnitude); the
    dd planes add the f32 hi+lo collapse (2^-22, summed).

    MIN/MAX: 0.0, the coarse key phase preserves order and the resolve
    phases are exact."""
    method = method.upper()
    if method in ("MIN", "MAX"):
        return 0.0
    base = float(k) * (float(k) * float(max_abs) / levels(bits))
    if error_feedback:
        base *= 2.0
    if dtype == "bfloat16":
        base += float(k) * float(max_abs) * 2.0 ** -8
    if dtype == "float64":
        base += float(k) * float(max_abs) * 2.0 ** -22
    return base


# ---------------------------------------------------------------------------
# block-scaled encode/decode (the wire form of the quantized SUM rings)
# ---------------------------------------------------------------------------


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """Pack int32 values in [-7, 7] two to a byte into a uint8 carrier,
    along the last axis (real packing: the declared bits/8 wire factor
    describes the bytes a hop moves)."""
    u = (q + 8).to(torch.uint8).unflatten(-1, (-1, 2))   # 1..15 a nibble
    return u[..., 0] | (u[..., 1] << 4)


def _unpack4(p: torch.Tensor) -> torch.Tensor:
    lo = (p & 0xF).to(torch.int32) - 8
    hi = ((p >> 4) & 0xF).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def block_encode(x: torch.Tensor, bits: int) -> tuple:
    """f32 (..., L) -> (carrier, per-block f32 scales (..., L/256)):
    symmetric per-block max-abs scaling, round half to even, clipped to
    +-levels(bits), each row on its own. L must divide by QUANT_BLOCK
    (and by 2 for the packed 4-bit carrier).

    The scale is max|x| times the float32 reciprocal of the levels: the
    JAX package writes max|x| / levels, and XLA's algebraic simplifier
    compiles that division by a constant into this multiplication in
    every jitted collective (an eager call divides, and can differ by an
    ulp of the scale)."""
    lv = levels(bits)
    xb = x.unflatten(-1, (-1, QUANT_BLOCK))
    s = xb.abs().amax(dim=-1) * float(np.float32(1.0 / lv))
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xb / s.unsqueeze(-1)), -lv, lv
                    ).to(torch.int32).flatten(-2)
    if bits == 4:
        return _pack4(q), s
    if bits == 8:
        return q.to(torch.int8), s
    return q.to(torch.int16), s


def block_decode(carrier: torch.Tensor, s: torch.Tensor, bits: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of block_encode: (..., L) in f32, or exact in f64 (a
    carrier value has at most 15 bits and a scale 24, so their product
    is exact in float64)."""
    q = _unpack4(carrier) if bits == 4 else carrier.to(torch.int32)
    return (q.unflatten(-1, (-1, QUANT_BLOCK)).to(dtype)
            * s.to(dtype).unsqueeze(-1)).flatten(-2)


def _add_decoded(acc: torch.Tensor, wire: tuple, bits: int,
                 sign: float = 1.0) -> torch.Tensor:
    """acc + sign * decode(wire) in f32, rounded once, as a fused
    multiply-add rounds it: XLA on the CPU contracts the JAX ring's
    `acc + q * s` (and the residual's `y - q * s`) into FMAs. The exact
    product and the sum are formed in float64, then rounded to float32;
    the two roundings differ from one only when the float64 sum lands
    exactly on a float32 midpoint."""
    dec = block_decode(*wire, bits, dtype=torch.float64)
    return (acc.to(torch.float64) + sign * dec).to(torch.float32)


def make_quant_sum_all_reduce(mesh, *, bits: int = 8,
                              dtype: str = "float32",
                              error_feedback: bool = True):
    """Approximate SUM across ranks with block-quantized ring traffic, on
    the ring scaffold (rings.ring_rs_ag_stateful): reduce-scatter, then
    all-gather; every hop carries (b-bit carrier, one f32 scale per
    QUANT_BLOCK elements). Accumulation stays f32: arrivals are decoded
    into the f32 partial, and only the chunk being sent is quantized.
    With error_feedback the residual of each encode is added to the next
    chunk this rank encodes. The gather phase circulates each owned chunk
    quantized once and its owner decodes its own encoding, so every
    replica is bit-identical.

    dtype shapes the collective's signature, rows (k_local, L):
      float32   f32 rows -> f32 replicas
      bfloat16  bf16 rows -> bf16 replicas (f32 accumulation)
      float64   (hi, lo) f32 dd planes -> (sum_f32, zeros): hi + lo
                collapsed in f32, as the JAX package does on the TPU

    Where quant_ring_applies is false the exact full-wire psum runs
    (algorithms.quant_ring_algorithm says so)."""
    from tpu_reductions_torch.collectives.core import Collective, psum

    k = mesh.k

    def to_wire(ch, resid):
        y = ch[0] + resid if error_feedback else ch[0]
        wire = block_encode(y, bits)
        if error_feedback:
            resid = _add_decoded(y, wire, bits, sign=-1.0)
        return wire, resid

    def absorb(tgt, rx):
        return (_add_decoded(tgt[0], rx, bits),)

    def from_wire(w):
        return (block_decode(*w, bits),)

    def reduce(x):
        # x: a (k_local, L) f32 tensor of its own, written in place
        if not quant_ring_applies(k, x.shape[1], bits):
            return psum(x, mesh)
        state = (torch.zeros((x.shape[0], x.shape[1] // k),
                             dtype=torch.float32, device=x.device)
                 if error_feedback else None)
        (x,), _ = ring_rs_ag_stateful(mesh, k, (x,), to_wire, absorb,
                                      from_wire, state)
        return x

    if dtype == "float64":
        def local(hi, lo):
            x = reduce(hi + lo)     # the dd collapse, in f32
            return x, torch.zeros_like(x)
        return Collective(local, mesh)

    def local(x):
        return reduce(x.to(torch.float32, copy=True)).to(x.dtype)
    return Collective(local, mesh)


def make_q8_sum_all_reduce(mesh):
    """The original int8/float32 ring: bits=8, no error feedback (its
    bound stays k*(k*M/127))."""
    return make_quant_sum_all_reduce(mesh, bits=8, dtype="float32",
                                     error_feedback=False)


# ---------------------------------------------------------------------------
# order-preserving quantized keys (MIN/MAX, exact by construction)
# ---------------------------------------------------------------------------


def monotone_key32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 view of f32: the low 31 bits of negative
    values flipped, so signed-int order equals float order (the f64
    analog is ops/dd_reduce.host_key_encode's high plane)."""
    i = x.view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def np_monotone_key32(x: np.ndarray) -> np.ndarray:
    """Host spelling of monotone_key32."""
    i = np.asarray(x, dtype=np.float32).view(np.int32)
    return np.where(i < 0, i ^ np.int32(0x7FFFFFFF), i)


def coarse_key(key32: torch.Tensor, bits: int) -> torch.Tensor:
    """The order-preserving b-bit quantization of a monotone int32 key:
    an arithmetic right shift keeps order (non-strict), and the result
    fits the signed b-bit carrier."""
    shifted = key32 >> (32 - bits)
    return shifted.to(torch.int8 if bits == 8 else torch.int16)


def _reduce_keys(c: torch.Tensor, method: str, mesh) -> torch.Tensor:
    """The op over every rank of a coarse-key plane: one (L,) tensor.
    Neither gloo's all_reduce nor NCCL's takes int16, so a phase that
    crosses processes runs widened to int32 and narrows back: the same
    values and bits."""
    from tpu_reductions_torch.collectives.core import reduce_ranks
    if not mesh.spans_processes:
        return reduce_ranks(c, method, mesh)
    return reduce_ranks(c.to(torch.int32), method, mesh).to(c.dtype)


def make_quant_key_minmax_all_reduce(method: str, mesh, *, bits: int = 8,
                                     dtype: str = "float32"):
    """Exact elementwise MIN/MAX across ranks via order-preserving
    quantized keys: phase 1 reduces the b-bit coarse keys (the compressed
    wire), then exact resolve phases run among the coarse ties only,
    every other rank masked to the op's identity (the tie-break of
    core.make_key_minmax_all_reduce). coarse_key is monotone, so the true
    winner's coarse key is phase 1's winner and the winner is among the
    candidates.

    dtype 'float32' takes one (k_local, L) f32 plane; 'float64' takes the
    (k_hi, k_lo) int32 key planes (ops/dd_reduce.host_key_encode) and
    returns the winning pair for host decode. Every row of the result
    holds the reduced values."""
    from tpu_reductions_torch.collectives.core import (Collective,
                                                       _replicate,
                                                       reduce_ranks)
    method = method.upper()
    if method not in ("MIN", "MAX"):
        raise ValueError(f"quantized key collectives are MIN/MAX, got "
                         f"{method}")

    if dtype == "float64":
        sent32 = 2**31 - 1 if method == "MIN" else -2**31

        def local(k_hi, k_lo):
            c = coarse_key(k_hi, bits)
            m_c = _reduce_keys(c, method, mesh)
            cand_hi = k_hi.masked_fill(c != m_c, sent32)
            m_hi = reduce_ranks(cand_hi, method, mesh)
            cand_lo = k_lo.masked_fill(k_hi != m_hi, sent32)
            m_lo = reduce_ranks(cand_lo, method, mesh)
            return _replicate(m_hi, mesh), _replicate(m_lo, mesh)
        return Collective(local, mesh)

    sent_val = float("inf") if method == "MIN" else float("-inf")

    def local(x):
        c = coarse_key(monotone_key32(x), bits)
        m_c = _reduce_keys(c, method, mesh)
        cand = x.masked_fill(c != m_c, sent_val)
        return _replicate(reduce_ranks(cand, method, mesh), mesh)
    return Collective(local, mesh)
