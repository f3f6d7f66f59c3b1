"""The f64 pair route: float64 reduced as two 32-bit planes.

The counterpart of tpu_reductions/ops/dd_reduce.py:1, the JAX package's
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
        version `dd_plain` for a CPU tensor; `dd_scalar_call` also folds
        the accumulator to one scalar pair by the JAX package's halving
        tree, in the same launch of csrc/pair.cu (its plain version:
        `device_finish_pairs` of `dd_plain`, the torch tree);
  host: `decode_pair_scalar` turns the 8-byte pair back into a float64
        (SUM: hi + lo, times 2^s; MIN/MAX: the inverse key map), or
        `host_finish_pairs` finishes the whole accumulator (--cpufinal).

The encodings are numpy and give the JAX package's bits; the pair
arithmetic is float32/int32 torch, which gives its bits too (additions
only, each rounded to nearest, nothing reassociated).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from tpu_reductions_torch.obs import spans
from tpu_reductions_torch.ops import _cuda
from tpu_reductions_torch.ops.kernel_reduce import (LANES, _pow2_ceil,
                                                    _sm_count, _tickets,
                                                    choose_tiling,
                                                    target_device)
from tpu_reductions_torch.utils.staging import maybe_chunked_stage

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
    full-range payloads.
    The counterpart of tpu_reductions/ops/dd_reduce.py:66."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def host_split_scaled(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Full-range f64 -> (hi, lo, s): the split of x * 2^-s, with s chosen
    so that the largest magnitude sits near 2^20. Rebuild with
    ldexp(hi + lo, s); the power-of-two scale is exact. Non-finite values
    are refused.
    The counterpart of tpu_reductions/ops/dd_reduce.py:79."""
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
    unsigned order becomes signed order. Exactly invertible.
    The counterpart of tpu_reductions/ops/dd_reduce.py:109."""
    b = np.ravel(np.asarray(x, dtype=np.float64)).view(np.uint64)
    sign = (b >> np.uint64(63)).astype(bool)
    key = np.where(sign, ~b, b ^ np.uint64(0x8000000000000000))
    k_hi = ((key >> np.uint64(32)) ^ np.uint64(0x80000000)).astype(
        np.uint32).view(np.int32)
    k_lo = ((key & np.uint64(0xFFFFFFFF)) ^ np.uint64(0x80000000)).astype(
        np.uint32).view(np.int32)
    return k_hi, k_lo


def host_key_decode(k_hi: np.ndarray, k_lo: np.ndarray) -> np.ndarray:
    """The inverse of host_key_encode, bit for bit.
    The counterpart of tpu_reductions/ops/dd_reduce.py:133."""
    hi_u = (np.asarray(k_hi).view(np.uint32).astype(np.uint64)
            ^ np.uint64(0x80000000))
    lo_u = (np.asarray(k_lo).view(np.uint32).astype(np.uint64)
            ^ np.uint64(0x80000000))
    key = (hi_u << np.uint64(32)) | lo_u
    sign = (key >> np.uint64(63)).astype(bool)   # set <=> x >= +0.0
    b = np.where(sign, key ^ np.uint64(0x8000000000000000), ~key)
    return b.view(np.float64)


def pad_pair(method: str) -> tuple:
    """The padding pair of a method: its identity in the pair encoding.
    The padding of tpu_reductions/ops/dd_reduce.py:149."""
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
    scale_exp=s (0 for MIN/MAX).
    The counterpart of tpu_reductions/ops/dd_reduce.py:149."""
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
    """a + b == s + err exactly (Knuth).
    The counterpart of tpu_reductions/ops/dd_reduce.py:189."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def dd_add(hi1, lo1, hi2, lo2):
    """(hi1, lo1) + (hi2, lo2), renormalised.
    The counterpart of tpu_reductions/ops/dd_reduce.py:197."""
    s, e = two_sum(hi1, hi2)
    e = e + (lo1 + lo2)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def dd_select(hi1, lo1, hi2, lo2, minimum: bool):
    """Elementwise lexicographic min or max of (hi, lo) key pairs; a tie
    keeps the first pair.
    The counterpart of tpu_reductions/ops/dd_reduce.py:206."""
    if minimum:
        take2 = (hi2 < hi1) | ((hi2 == hi1) & (lo2 < lo1))
    else:
        take2 = (hi2 > hi1) | ((hi2 == hi1) & (lo2 > lo1))
    return torch.where(take2, hi2, hi1), torch.where(take2, lo2, lo1)


def dd_combine(method: str):
    """The pair combine of a method: dd_add, or dd_select as MIN/MAX.
    The choice that tpu_reductions/ops/dd_reduce.py:220 makes."""
    method = method.upper()
    if method == "SUM":
        return dd_add
    minimum = method == "MIN"
    return lambda h1, l1, h2, l2: dd_select(h1, l1, h2, l2, minimum)


def halving_tree(hi: torch.Tensor, lo: torch.Tensor, method: str):
    """Fold (m, ...) pair planes over their first axis, m a power of two,
    by combining the first half with the second until one row is left.
    The tree of tpu_reductions/ops/dd_reduce.py:287."""
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
    congruent to r modulo TM of column c.
    The function of tpu_reductions/ops/dd_reduce.py:227, the TPU kernel."""
    combine = dd_combine(method)
    hi = hi2d.reshape(-1, tm, LANES)
    lo = lo2d.reshape(-1, tm, LANES)
    acc_hi, acc_lo = hi[0].clone(), lo[0].clone()
    for k in range(1, hi.shape[0]):
        acc_hi, acc_lo = combine(acc_hi, acc_lo, hi[k], lo[k])
    return acc_hi, acc_lo


# csrc/pair.cu: the threads of a CTA, the most slots a pass-2 thread
# and a thread of the last CTA take, and the slots a pass-2 thread aims at
DD_TEAM = 256
DD_MAX_LEAVES = 32
DD_MAX_TAIL = 32
DD_LEAVES = 4
# pass 1's CTAs per SM, and the most splits: the last CTA of a slot group
# folds all of the group's partials alone
DD_CTAS_PER_SM = 2
DD_MAX_SPLITS = 32


@dataclasses.dataclass(frozen=True)
class DdPlan:
    """The geometry of one dd launch (csrc/pair.cu). Pass 1: CTA (g, s)
    of the (TM / 8) x `splits` grid folds slot group g of the tiles s,
    s + splits, ... in increasing order, and the last CTA of each group
    folds the group's splits. Pass 2: `residues` (2^m) threads, thread r
    running the top levels of the tree over the slots congruent to r
    modulo 2^m; the last CTA to finish folds the 2^m pairs to the
    scalar.
    The grid of tpu_reductions/ops/dd_reduce.py:250 on the card."""
    splits: int
    residues: int


def plan_dd(tiles: int, tm: int, sm_count: int) -> DdPlan:
    """dd's geometry, from the shape and the SM count alone, so one
    shape always folds in one order. Pass 1 takes as many splits as keep
    its grid at DD_CTAS_PER_SM CTAs an SM (each CTA keeps 64 KiB of
    loads in flight), at most one per tile and DD_MAX_SPLITS. Pass 2
    gives each thread DD_LEAVES slots of the padded accumulator, within
    at least one CTA and at most DD_MAX_TAIL pairs a thread of the last
    CTA. bench/passes.py --sweep times the other choices.
    The grid of tpu_reductions/ops/dd_reduce.py:250 on the card."""
    splits = max(1, min(tiles, DD_MAX_SPLITS,
                        DD_CTAS_PER_SM * sm_count // (tm // SUBLANES)))
    residues = min(DD_TEAM * DD_MAX_TAIL,
                   max(DD_TEAM, _pow2_ceil(tm * LANES) // DD_LEAVES))
    return DdPlan(splits, residues)


def _out_words(tm: int, plan: DdPlan) -> int:
    """The 32-bit words of a launch's output buffer (csrc/pair.cu run):
    the accumulator's two planes, the scalar pair and two words of
    padding, the split partials' two planes (when there are splits) and
    the tree's two planes."""
    size = tm * LANES
    parts = 2 * plan.splits * size if plan.splits > 1 else 0
    return 2 * size + 4 + parts + 2 * plan.residues


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
        if plane.data_ptr() % 16:
            raise ValueError("the planes must start on a 16-byte boundary")
    if hi2d.shape != lo2d.shape or hi2d.device != lo2d.device:
        raise ValueError(f"the two planes differ: {tuple(hi2d.shape)} on "
                         f"{hi2d.device}, {tuple(lo2d.shape)} on "
                         f"{lo2d.device}")
    if tm <= 0 or tm % SUBLANES or hi2d.shape[0] % tm:
        raise ValueError(f"the pair kernel needs tm a multiple of "
                         f"{SUBLANES} and rows % tm == 0, got "
                         f"{hi2d.shape[0]} rows with tm={tm}")


def _launch(hi2d: torch.Tensor, lo2d: torch.Tensor, method: str, tm: int,
            scalar: bool) -> torch.Tensor:
    """One launch of csrc/pair.cu on hi2d's device and current stream,
    planned by plan_dd: pass 1 (the accumulator), and with `scalar` pass 2
    (the pair finish). Returns its output buffer (_out_words). Counts one
    dd launch in dd_call.launches."""
    _check_planes(hi2d, lo2d, method, tm)
    plan = plan_dd(hi2d.shape[0] // tm, tm, _sm_count(hi2d.device))
    out = torch.empty(_out_words(tm, plan), dtype=hi2d.dtype,
                      device=hi2d.device)
    _cuda.dd_reduce(hi2d, lo2d, out, _tickets(hi2d.device), tm, plan, method,
                    scalar)
    dd_call.launches += 1
    return out


def dd_call(hi2d: torch.Tensor, lo2d: torch.Tensor, method: str,
            tm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (TM, 128) pair accumulator of two staged planes (float32 for
    SUM, int32 keys for MIN/MAX). A CPU tensor takes dd_plain; a CUDA
    tensor launches csrc/pair.cu's pass 1, which folds its splits too (one
    CUDA launch), or raises. `dd_call.launches` counts the launches of
    the dd kernel, from this wrapper and from dd_scalar_call.
    The counterpart of tpu_reductions/ops/dd_reduce.py:250."""
    method = method.upper()
    if hi2d.device.type == "cpu" and lo2d.device.type == "cpu":
        return dd_plain(hi2d, lo2d, method, tm)
    size = tm * LANES
    out = _launch(hi2d, lo2d, method, tm, scalar=False)
    return out[:size].view(tm, LANES), out[size:2 * size].view(tm, LANES)


dd_call.launches = 0


def dd_scalar_call(hi2d: torch.Tensor, lo2d: torch.Tensor, method: str,
                   tm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The scalar pair (s_hi, s_lo), two 0-d tensors on the planes'
    device: the accumulator folded by the JAX package's halving tree.
    Equal bit for bit to device_finish_pairs(*dd_call(...)) of the same
    planes. A CPU tensor takes exactly that composition of the plain
    versions; a CUDA tensor launches csrc/pair.cu once, the finish fused
    behind the accumulator with no torch op between (two CUDA launches,
    the second a programmatic dependent of the first), or raises.
    The counterpart of tpu_reductions/ops/dd_reduce.py:250 and
    tpu_reductions/ops/dd_reduce.py:287 together."""
    method = method.upper()
    if hi2d.device.type == "cpu" and lo2d.device.type == "cpu":
        return device_finish_pairs(*dd_plain(hi2d, lo2d, method, tm), method)
    size = tm * LANES
    out = _launch(hi2d, lo2d, method, tm, scalar=True)
    return out[2 * size], out[2 * size + 1]


# ---------------------------------------------------------------------------
# Finishes
# ---------------------------------------------------------------------------


def device_finish_pairs(acc_hi: torch.Tensor, acc_lo: torch.Tensor,
                        method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a pair accumulator to one scalar pair on its device: pad the
    flattened planes to a power of two with the padding pair, then a
    halving tree of the same combine the kernel uses. About
    log2(TM*128) levels of ten elementwise torch ops each.
    The counterpart of tpu_reductions/ops/dd_reduce.py:287."""
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
    key map.
    The counterpart of tpu_reductions/ops/dd_reduce.py:336."""
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
    the selection ignores NaNs.
    The counterpart of tpu_reductions/ops/dd_reduce.py:442."""
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

    def put(plane: np.ndarray, pad) -> torch.Tensor:
        host = torch.from_numpy(plane)
        staged = maybe_chunked_stage(host, *plane.shape, pad, device)
        # redlint: disable=RED015 -- the one-shot copy only where maybe_chunked_stage judged the plane under the staging threshold
        return host.to(device) if staged is None else staged

    def stage_fn(x):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        hi, lo, _, s = stage_split_padded(x, method, threads, max_blocks)
        pads = pad_pair(method)
        return put(hi, pads[0].item()), put(lo, pads[1].item()), s

    return stage_fn


def make_dd_device_reduce(method: str, n: int, *, threads: int = 256,
                          max_blocks: int = 64,
                          device: Optional[torch.device] = None):
    """(stage_fn, core, finish) of the all-device f64 pair route:
    stage_fn(payload) -> (hi2d, lo2d, s); core(hi2d, lo2d) -> (s_hi, s_lo),
    the kernel and the pair finish on the device, chainable;
    finish(s_hi, s_lo, scale_exp) -> np.float64 from 8 bytes.
    The counterpart of tpu_reductions/ops/dd_reduce.py:375."""
    method = method.upper()
    tm, _, _ = choose_tiling(n, threads, max_blocks)
    stage_fn = _make_stage_fn(method, threads, max_blocks, device)

    def core(hi2d, lo2d):
        return dd_scalar_call(hi2d, lo2d, method, tm)

    def finish(s_hi, s_lo, scale_exp=0):
        return decode_pair_scalar(s_hi, s_lo, method, scale_exp=scale_exp)

    return stage_fn, core, finish


def make_dd_staged_reduce(method: str, n: int, *, threads: int = 256,
                          max_blocks: int = 64,
                          device: Optional[torch.device] = None):
    """(stage_fn, reduce_fn) of the --cpufinal spelling: reduce_fn(hi2d,
    lo2d, scale_exp) runs the kernel and finishes the accumulator on the
    host.
    The counterpart of tpu_reductions/ops/dd_reduce.py:467."""
    method = method.upper()
    tm, _, _ = choose_tiling(n, threads, max_blocks)
    stage_fn = _make_stage_fn(method, threads, max_blocks, device)

    def reduce_fn(hi2d, lo2d, scale_exp=0):
        rec = spans.hot_begin()
        if rec is None:
            acc_hi, acc_lo = dd_call(hi2d, lo2d, method, tm)
            return host_finish_pairs(acc_hi, acc_lo, method,
                                     scale_exp=scale_exp)
        # recorded (obs/spans.py): `reduce` and its finish
        return spans.hot_call(
            rec, lambda: dd_call(hi2d, lo2d, method, tm),
            lambda acc: host_finish_pairs(*acc, method,
                                          scale_exp=scale_exp))

    return stage_fn, reduce_fn


def dd_reduce_f64(x: Union[np.ndarray, torch.Tensor], method: str = "SUM",
                  *, threads: int = 256, max_blocks: int = 64,
                  device: Union[str, torch.device, None] = None
                  ) -> np.float64:
    """One-shot f64 reduce through the pair route: host split, the pair
    kernel, host finish. Runs on `device`, else on a CUDA tensor's own
    card, else on the card.
    The counterpart of tpu_reductions/ops/dd_reduce.py:491."""
    xt = torch.as_tensor(x, dtype=torch.float64)
    stage_fn, reduce_fn = make_dd_staged_reduce(
        method, xt.numel(), threads=threads, max_blocks=max_blocks,
        device=target_device(xt, device))
    return reduce_fn(*stage_fn(xt.cpu()))


def dd_sum_f64(x: torch.Tensor, *, threads: int = 256,
               max_blocks: int = 64) -> torch.Tensor:
    """f64 SUM of a tensor through the pair kernel on its own device. The
    card has f64, so the (unscaled) split runs there; the accumulator is
    widened and summed in float64. Returns a 0-d float64 tensor.
    The counterpart of tpu_reductions/ops/dd_reduce.py:509."""
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
