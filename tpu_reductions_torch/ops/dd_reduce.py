"""The f64 pair route: float64 reduced as two 32-bit planes.

The counterpart of tpu_reductions/ops/dd_reduce.py, the JAX package's
route for float64 on a chip without native f64. Here it runs where the
driver is asked for it (`--f64=dd`) and in the streaming pipeline, which
streams float64 as pairs on every platform (ops/stream.py).

  host: encode the f64 payload as two 32-bit planes, padded to
        (P*T*TM, 128) (`stage_split_padded`):
          SUM      (hi, lo) float32 double-double planes of x * 2^-s, where
                   the exact power-of-two scale s puts the largest magnitude
                   near 2^20 (`host_split_scaled`), zero-padded;
          MIN/MAX  (k_hi, k_lo) int32 order keys whose signed lexicographic
                   order is the f64 order (`host_key_encode`), padded with
                   the largest or smallest key pair;
  card: `dd_call` folds both planes into a (TM, 128) pair accumulator with
        the error-free transformations (`dd_add` for SUM, `dd_select` for
        MIN/MAX): the hand-written kernel csrc/pair.cu, or its plain
        version `dd_plain` for a CPU tensor; `device_finish_pairs` folds
        the accumulator to one scalar pair by a halving tree;
  host: `decode_pair_scalar` turns the 8-byte pair back into a float64
        (SUM: hi + lo, times 2^s; MIN/MAX: the inverse key map), or
        `host_finish_pairs` finishes the whole accumulator (--cpufinal).

The encodings are numpy and give the JAX package's bits; the pair
arithmetic is float32/int32 torch, which gives its bits too (additions
only, each rounded to nearest, nothing reassociated).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tpu_reductions_torch.ops import _cuda
from tpu_reductions_torch.ops.kernel_reduce import (LANES, _sm_count,
                                                    choose_tiling,
                                                    target_device)

SUBLANES = 8     # rows of one slot group of the pair accumulator
_I32_MAX = np.int32(2**31 - 1)
_I32_MIN = np.int32(-2**31)
PLANE_DTYPES = {"SUM": torch.float32, "MIN": torch.int32,
                "MAX": torch.int32}


# ---------------------------------------------------------------------------
# Encodings (host, numpy)
# ---------------------------------------------------------------------------


def host_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f64 -> (hi, lo) float32 with hi + lo == x to about 48 bits. It
    overflows for |x| above the float32 range: host_split_scaled takes
    full-range payloads."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def host_split_scaled(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Full-range f64 -> (hi, lo, s): the split of x * 2^-s, with s chosen
    so that the largest magnitude sits near 2^20. Rebuild with
    ldexp(hi + lo, s); the power-of-two scale is exact. Non-finite values
    are refused."""
    x = np.asarray(x, dtype=np.float64)
    m = float(np.max(np.abs(x))) if x.size else 0.0
    if not np.isfinite(m):
        raise ValueError("payload contains non-finite values; the dd "
                         "split requires finite f64")
    s = int(np.floor(np.log2(m))) - 20 if m > 0.0 else 0
    hi, lo = host_split(np.ldexp(x, -s))
    return hi, lo, s


def host_key_encode(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f64 -> (k_hi, k_lo) int32 keys whose signed lexicographic order is
    the f64 order: for the uint64 bits b, key = b ^ 2^63 when the sign is
    clear, ~b when it is set; each 32-bit half then flips its top bit, so
    unsigned order becomes signed order. Exactly invertible."""
    b = np.ravel(np.asarray(x, dtype=np.float64)).view(np.uint64)
    sign = (b >> np.uint64(63)).astype(bool)
    key = np.where(sign, ~b, b ^ np.uint64(0x8000000000000000))
    k_hi = ((key >> np.uint64(32)) ^ np.uint64(0x80000000)).astype(
        np.uint32).view(np.int32)
    k_lo = ((key & np.uint64(0xFFFFFFFF)) ^ np.uint64(0x80000000)).astype(
        np.uint32).view(np.int32)
    return k_hi, k_lo


def host_key_decode(k_hi: np.ndarray, k_lo: np.ndarray) -> np.ndarray:
    """The inverse of host_key_encode, bit for bit."""
    hi_u = (np.asarray(k_hi).view(np.uint32).astype(np.uint64)
            ^ np.uint64(0x80000000))
    lo_u = (np.asarray(k_lo).view(np.uint32).astype(np.uint64)
            ^ np.uint64(0x80000000))
    key = (hi_u << np.uint64(32)) | lo_u
    sign = (key >> np.uint64(63)).astype(bool)   # set <=> x >= +0.0
    b = np.where(sign, key ^ np.uint64(0x8000000000000000), ~key)
    return b.view(np.float64)


def pad_pair(method: str) -> tuple:
    """The padding pair of a method: its identity in the pair encoding."""
    method = method.upper()
    if method == "SUM":
        return np.float32(0.0), np.float32(0.0)
    return ((_I32_MAX, _I32_MAX) if method == "MIN"
            else (_I32_MIN, _I32_MIN))


def stage_split_padded(x: np.ndarray, method: str, threads: int = 256,
                       max_blocks: int = 64
                       ) -> tuple[np.ndarray, np.ndarray,
                                  tuple[int, int, int], int]:
    """Encode an f64 payload as two 32-bit planes padded to
    (P*T*TM, 128): (plane_hi, plane_lo, (tm, p, t), s). Finish with
    scale_exp=s (0 for MIN/MAX)."""
    method = method.upper()
    flat = np.ravel(np.asarray(x, dtype=np.float64))
    tm, p, t = choose_tiling(flat.size, threads, max_blocks)
    rows = p * t * tm
    pad = rows * LANES - flat.size
    s = 0
    if method == "SUM":
        hi, lo, s = host_split_scaled(flat)
    else:
        hi, lo = host_key_encode(flat)
    pads = pad_pair(method)
    hi = np.pad(hi, (0, pad), constant_values=pads[0]).reshape(rows, LANES)
    lo = np.pad(lo, (0, pad), constant_values=pads[1]).reshape(rows, LANES)
    return hi, lo, (tm, p, t), s


# ---------------------------------------------------------------------------
# Error-free transformations (torch, elementwise)
# ---------------------------------------------------------------------------


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """a + b == s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def dd_add(hi1, lo1, hi2, lo2):
    """(hi1, lo1) + (hi2, lo2), renormalised."""
    s, e = two_sum(hi1, hi2)
    e = e + (lo1 + lo2)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def dd_select(hi1, lo1, hi2, lo2, minimum: bool):
    """Elementwise lexicographic min or max of (hi, lo) key pairs; a tie
    keeps the first pair."""
    if minimum:
        take2 = (hi2 < hi1) | ((hi2 == hi1) & (lo2 < lo1))
    else:
        take2 = (hi2 > hi1) | ((hi2 == hi1) & (lo2 > lo1))
    return torch.where(take2, hi2, hi1), torch.where(take2, lo2, lo1)


def dd_combine(method: str):
    """The pair combine of a method: dd_add, or dd_select as MIN/MAX."""
    method = method.upper()
    if method == "SUM":
        return dd_add
    minimum = method == "MIN"
    return lambda h1, l1, h2, l2: dd_select(h1, l1, h2, l2, minimum)


def halving_tree(hi: torch.Tensor, lo: torch.Tensor, method: str):
    """Fold (m, ...) pair planes over their first axis, m a power of two,
    by combining the first half with the second until one row is left."""
    combine = dd_combine(method)
    while hi.shape[0] > 1:
        h = hi.shape[0] // 2
        hi, lo = combine(hi[:h], lo[:h], hi[h:], lo[h:])
    return hi[0], lo[0]


# ---------------------------------------------------------------------------
# The pair accumulator: plain version and kernel wrapper
# ---------------------------------------------------------------------------


def dd_plain(hi2d: torch.Tensor, lo2d: torch.Tensor, method: str,
             tm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dd's function in PyTorch: slot (r, c) of the (TM, 128) accumulator
    folds, in tile order and starting from tile 0's pair, the staged rows
    congruent to r modulo TM of column c."""
    combine = dd_combine(method)
    hi = hi2d.reshape(-1, tm, LANES)
    lo = lo2d.reshape(-1, tm, LANES)
    acc_hi, acc_lo = hi[0].clone(), lo[0].clone()
    for k in range(1, hi.shape[0]):
        acc_hi, acc_lo = combine(acc_hi, acc_lo, hi[k], lo[k])
    return acc_hi, acc_lo


def _check_planes(hi2d: torch.Tensor, lo2d: torch.Tensor, method: str,
                  tm: int) -> None:
    """Refuse what the pair kernel does not take."""
    want = PLANE_DTYPES[method]
    for plane in (hi2d, lo2d):
        if plane.device.type != "cuda":
            raise ValueError(f"the pair kernel runs on CUDA tensors (CPU "
                             f"tensors take the plain version), got "
                             f"{plane.device}")
        if plane.dtype != want:
            raise ValueError(f"{method} pairs are {want} planes, got "
                             f"{plane.dtype}")
        if (plane.dim() != 2 or plane.shape[1] != LANES
                or not plane.is_contiguous()):
            raise ValueError(f"expected contiguous (rows, {LANES}) planes, "
                             f"got {tuple(plane.shape)}")
    if hi2d.shape != lo2d.shape or hi2d.device != lo2d.device:
        raise ValueError(f"the two planes differ: {tuple(hi2d.shape)} on "
                         f"{hi2d.device}, {tuple(lo2d.shape)} on "
                         f"{lo2d.device}")
    if tm <= 0 or tm % SUBLANES or hi2d.shape[0] % tm:
        raise ValueError(f"the pair kernel needs tm a multiple of "
                         f"{SUBLANES} and rows % tm == 0, got "
                         f"{hi2d.shape[0]} rows with tm={tm}")


def dd_call(hi2d: torch.Tensor, lo2d: torch.Tensor, method: str,
            tm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (TM, 128) pair accumulator of two staged planes (float32 for
    SUM, int32 keys for MIN/MAX). A CPU tensor takes dd_plain; a CUDA
    tensor launches csrc/pair.cu (its two passes, the split partials and
    their fold, count as one launch) or raises."""
    method = method.upper()
    if hi2d.device.type == "cpu" and lo2d.device.type == "cpu":
        return dd_plain(hi2d, lo2d, method, tm)
    _check_planes(hi2d, lo2d, method, tm)
    tiles = hi2d.shape[0] // tm
    # as kernel_reduce._period_buffers: the tm/8 slot groups x splits
    # blocks of 1024 threads fill one wave at two blocks per SM
    splits = max(1, min(tiles, 2 * _sm_count(hi2d.device)
                        // (tm // SUBLANES)))
    out = [torch.empty((tm, LANES), dtype=hi2d.dtype, device=hi2d.device)
           for _ in range(2)]
    parts = ([torch.empty((splits * tm, LANES), dtype=hi2d.dtype,
                          device=hi2d.device) for _ in range(2)]
             if splits > 1 else out)
    _cuda.dd_reduce(hi2d, lo2d, parts[0], parts[1], out[0], out[1], tm,
                    splits, method)
    dd_call.launches += 1
    return out[0], out[1]


dd_call.launches = 0


# ---------------------------------------------------------------------------
# Finishes
# ---------------------------------------------------------------------------


def device_finish_pairs(acc_hi: torch.Tensor, acc_lo: torch.Tensor,
                        method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a pair accumulator to one scalar pair on its device: pad the
    flattened planes to a power of two with the padding pair, then a
    halving tree of the same combine the kernel uses. About
    log2(TM*128) levels of ten elementwise torch ops each."""
    hi, lo = acc_hi.reshape(-1), acc_lo.reshape(-1)
    size = hi.shape[0]
    pow2 = 1 << max(size - 1, 0).bit_length()
    if pow2 != size:
        pads = pad_pair(method)
        hi = torch.cat([hi, torch.full((pow2 - size,), pads[0].item(),
                                       dtype=hi.dtype, device=hi.device)])
        lo = torch.cat([lo, torch.full((pow2 - size,), pads[1].item(),
                                       dtype=lo.dtype, device=lo.device)])
    return halving_tree(hi, lo, method)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def decode_pair_scalar(s_hi, s_lo, method: str,
                       scale_exp: int = 0) -> np.float64:
    """The final scalar pair (8 bytes) as a float64 on the host: SUM adds
    the halves and undoes the staging scale exactly; MIN/MAX invert the
    key map."""
    s_hi, s_lo = _host(s_hi), _host(s_lo)
    if method.upper() == "SUM":
        z = float(s_hi) + float(s_lo)
        return np.float64(np.ldexp(z, scale_exp))
    return np.float64(host_key_decode(np.asarray(s_hi, dtype=np.int32),
                                      np.asarray(s_lo, dtype=np.int32)))


def host_finish_pairs(acc_hi, acc_lo, method: str,
                      scale_exp: int = 0) -> np.float64:
    """Finish the whole pair accumulator on the host (--cpufinal): SUM
    widens both planes to float64 and sums them, then undoes the scale;
    MIN/MAX decode the keys and select. A slot that only ever held the
    padding pair decodes to NaN (the padding key is no float's image), so
    the selection ignores NaNs."""
    hi, lo = _host(acc_hi), _host(acc_lo)
    method = method.upper()
    if method == "SUM":
        z = hi.astype(np.float64) + lo.astype(np.float64)
        return np.float64(np.ldexp(z.sum(), scale_exp))
    vals = host_key_decode(hi, lo)
    return np.float64(np.nanmin(vals) if method == "MIN"
                      else np.nanmax(vals))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _make_stage_fn(method: str, threads: int, max_blocks: int,
                   device: Optional[torch.device]):
    """stage_fn(payload) -> (hi2d, lo2d, s): both planes on `device`, and
    the scale the finish undoes."""

    def stage_fn(x):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        hi, lo, _, s = stage_split_padded(x, method, threads, max_blocks)
        return (torch.from_numpy(hi).to(device),
                torch.from_numpy(lo).to(device), s)

    return stage_fn


def make_dd_device_reduce(method: str, n: int, *, threads: int = 256,
                          max_blocks: int = 64,
                          device: Optional[torch.device] = None):
    """(stage_fn, core, finish) of the all-device f64 pair route:
    stage_fn(payload) -> (hi2d, lo2d, s); core(hi2d, lo2d) -> (s_hi, s_lo),
    the kernel and the pair finish on the device, chainable;
    finish(s_hi, s_lo, scale_exp) -> np.float64 from 8 bytes."""
    method = method.upper()
    tm, _, _ = choose_tiling(n, threads, max_blocks)
    stage_fn = _make_stage_fn(method, threads, max_blocks, device)

    def core(hi2d, lo2d):
        return device_finish_pairs(*dd_call(hi2d, lo2d, method, tm), method)

    def finish(s_hi, s_lo, scale_exp=0):
        return decode_pair_scalar(s_hi, s_lo, method, scale_exp=scale_exp)

    return stage_fn, core, finish


def make_dd_staged_reduce(method: str, n: int, *, threads: int = 256,
                          max_blocks: int = 64,
                          device: Optional[torch.device] = None):
    """(stage_fn, reduce_fn) of the --cpufinal spelling: reduce_fn(hi2d,
    lo2d, scale_exp) runs the kernel and finishes the accumulator on the
    host."""
    method = method.upper()
    tm, _, _ = choose_tiling(n, threads, max_blocks)
    stage_fn = _make_stage_fn(method, threads, max_blocks, device)

    def reduce_fn(hi2d, lo2d, scale_exp=0):
        acc_hi, acc_lo = dd_call(hi2d, lo2d, method, tm)
        return host_finish_pairs(acc_hi, acc_lo, method,
                                 scale_exp=scale_exp)

    return stage_fn, reduce_fn


def dd_reduce_f64(x: Union[np.ndarray, torch.Tensor], method: str = "SUM",
                  *, threads: int = 256, max_blocks: int = 64,
                  device: Union[str, torch.device, None] = None
                  ) -> np.float64:
    """One-shot f64 reduce through the pair route: host split, the pair
    kernel, host finish. Runs on `device`, else on a CUDA tensor's own
    card, else on the card."""
    xt = torch.as_tensor(x, dtype=torch.float64)
    stage_fn, reduce_fn = make_dd_staged_reduce(
        method, xt.numel(), threads=threads, max_blocks=max_blocks,
        device=target_device(xt, device))
    return reduce_fn(*stage_fn(xt.cpu()))


def dd_sum_f64(x: torch.Tensor, *, threads: int = 256,
               max_blocks: int = 64) -> torch.Tensor:
    """f64 SUM of a tensor through the pair kernel on its own device. The
    card has f64, so the (unscaled) split runs there; the accumulator is
    widened and summed in float64. Returns a 0-d float64 tensor."""
    if x.dtype != torch.float64:
        raise ValueError(f"dd_sum_f64 takes float64, got {x.dtype}")
    flat = x.reshape(-1)
    tm, p, t = choose_tiling(flat.numel(), threads, max_blocks)
    rows = p * t * tm
    padded = torch.zeros(rows * LANES, dtype=torch.float64,
                         device=flat.device)
    padded[:flat.numel()] = flat
    hi = padded.to(torch.float32)
    lo = (padded - hi.to(torch.float64)).to(torch.float32)
    acc_hi, acc_lo = dd_call(hi.view(rows, LANES), lo.view(rows, LANES),
                             "SUM", tm)
    return torch.sum(acc_hi.to(torch.float64) + acc_lo.to(torch.float64))
