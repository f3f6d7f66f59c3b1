"""Single-chip reduction kernels k6 and k7: staging, wrappers, plain
versions and the multi-pass finish.

The counterpart of tpu_reductions/ops/pallas_reduce.py. The payload is
staged once, untimed, into an identity-padded (P*T*TM, 128) tensor on the
device (`choose_tiling`, `stage_padded`: --threads sets the TM tile rows,
--maxblocks the P partial blocks). Then:

  k6  single_pass_call -> one (sub, 128) accumulator, finished to a scalar;
  k7  two_pass_call    -> (P*sub, 128) partials, relaunched on its own
                          partials by _multipass_finish while more than
                          --cputhresh rows remain, then finished on the
                          device or, with --cpufinal, on the host.

sub is 8 rows, or 16 for bf16. Slot (r, c) of a (sub, 128) block is the
combine, over the rows the block covers that are congruent to r modulo
sub, of column c; that definition does not depend on the tiling, so the
CUDA kernels (csrc/reduce.cu) are free to pick their own launch geometry
and still equal the JAX kernels element by element for int32 and MIN/MAX.

Each wrapper takes its plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel (or raises), and counts the
launch in its `launches` attribute.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import (KERNEL_SINGLE_PASS,
                                         KERNEL_TWO_PASS,
                                         NOT_PORTED_KERNELS,
                                         not_ported_message)
from tpu_reductions_torch.ops import _cuda
from tpu_reductions_torch.ops.oracle import host_value
from tpu_reductions_torch.ops.registry import (ReduceOpSpec, accum_dtype,
                                               get_op, torch_dtype)

LANES = 128      # row width of the staged layout (the TPU's lane count)

DtypeLike = Union[str, torch.dtype]


def sublanes_for(dtype: DtypeLike) -> int:
    """Accumulator rows by element width: 8 for 32- and 64-bit types, 16
    for bf16 (the JAX package's sublane tiling)."""
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    return {8: 8, 4: 8, 2: 16, 1: 32}[dtype.itemsize]


def _acc_dtype(in_dtype: torch.dtype, op: ReduceOpSpec) -> torch.dtype:
    """f32 for bf16 SUM, the input dtype otherwise."""
    return accum_dtype(in_dtype) if op.name == "SUM" else in_dtype


def choose_tiling(n: int, threads: int = 256, max_blocks: int = 64,
                  dtype: DtypeLike = torch.float32) -> tuple[int, int, int]:
    """(TM tile rows, P partial blocks, T tiles per block) for n elements,
    with P*T*TM*128 >= n and TM a multiple of the dtype's sublane count."""
    sub = sublanes_for(dtype)
    rows = -(-n // LANES)
    tm = max(sub, min(int(threads), 2048))
    tm -= tm % sub
    num_tiles = -(-rows // tm)
    p = max(1, min(int(max_blocks), num_tiles))
    t = -(-num_tiles // p)
    return tm, p, t


def padded_2d_shape(n: int, tm: int, p: int, t: int) -> tuple[int, int]:
    """(rows, LANES) layout of n elements under the (tm, p, t) tiling."""
    return (p * t * tm, LANES)


def stage_padded(x: torch.Tensor, tm: int, p: int, t: int, op: ReduceOpSpec,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Copy a flat payload into a (P*T*TM, 128) tensor on `device` (x's
    own by default), padded with the op's identity."""
    flat = x.reshape(-1)
    device = flat.device if device is None else device
    rows, lanes = padded_2d_shape(flat.numel(), tm, p, t)
    out = torch.full((rows * lanes,), op.identity(flat.dtype),
                     dtype=flat.dtype, device=device)
    out[:flat.numel()].copy_(flat)
    return out.view(rows, lanes)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def single_pass_plain(x2d: torch.Tensor, op: ReduceOpSpec) -> torch.Tensor:
    """k6's function in PyTorch: the (sub, 128) accumulator of all rows."""
    sub = sublanes_for(x2d.dtype)
    return op.reduce_dim(x2d.reshape(-1, sub, LANES), 0)


def two_pass_plain(x2d: torch.Tensor, op: ReduceOpSpec, tm: int, p: int,
                   t: int) -> torch.Tensor:
    """k7's function in PyTorch: block i's (sub, 128) partial of its rows
    [i*T*TM, (i+1)*T*TM), stacked to (P*sub, 128)."""
    sub = sublanes_for(x2d.dtype)
    parts = op.reduce_dim(x2d.reshape(p, t * tm // sub, sub, LANES), 1)
    return parts.reshape(p * sub, LANES)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_staged(x2d: torch.Tensor, sub: int) -> None:
    """Refuse what the CUDA kernels do not take."""
    if x2d.device.type != "cuda":
        raise ValueError(f"the reduction kernels run on CUDA tensors (CPU "
                         f"tensors take the plain version), got "
                         f"{x2d.device}")
    if x2d.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"no kernel for dtype {x2d.dtype}")
    if (x2d.dim() != 2 or x2d.shape[1] != LANES or x2d.shape[0] % sub
            or not x2d.is_contiguous()):
        raise ValueError(f"expected a contiguous (rows, {LANES}) tensor "
                         f"with rows a multiple of {sub}, got "
                         f"{tuple(x2d.shape)}")


def single_pass_call(x2d: torch.Tensor, op: ReduceOpSpec) -> torch.Tensor:
    """k6: the (sub, 128) accumulator of a staged tensor. Two CUDA passes
    (grid-stride partials, then one block folds them) count as one
    launch."""
    if x2d.device.type == "cpu":
        return single_pass_plain(x2d, op)
    sub = sublanes_for(x2d.dtype)
    _check_staged(x2d, sub)
    blocks = min(2 * _sm_count(x2d.device), x2d.shape[0] // sub)
    acc = _acc_dtype(x2d.dtype, op)
    partials = torch.empty((blocks * sub, LANES), dtype=acc,
                           device=x2d.device)
    out = torch.empty((sub, LANES), dtype=acc, device=x2d.device)
    _cuda.k6_reduce(x2d, partials, out, blocks, op.name)
    single_pass_call.launches += 1
    return out


single_pass_call.launches = 0


def two_pass_call(x2d: torch.Tensor, op: ReduceOpSpec, tm: int, p: int,
                  t: int) -> torch.Tensor:
    """k7: the (P*sub, 128) partials of a staged (P*T*TM, 128) tensor."""
    if x2d.device.type == "cpu":
        return two_pass_plain(x2d, op, tm, p, t)
    sub = sublanes_for(x2d.dtype)
    _check_staged(x2d, sub)
    if x2d.shape[0] != p * t * tm:
        raise ValueError(f"k7 needs {p * t * tm} rows for tiling "
                         f"({tm}, {p}, {t}), got {x2d.shape[0]}")
    out = torch.empty((p * sub, LANES), dtype=_acc_dtype(x2d.dtype, op),
                      device=x2d.device)
    _cuda.k7_reduce(x2d, out, t * tm, p, op.name)
    two_pass_call.launches += 1
    return out


two_pass_call.launches = 0


def _multipass_finish(partials: torch.Tensor, op: ReduceOpSpec, threads: int,
                      max_blocks: int, cpu_thresh: int) -> torch.Tensor:
    """Relaunch k7 on its own partials while more than cpu_thresh rows
    remain and a further pass can shrink them. Two guards end the loop:
    the partials' own sublane count is the floor, and each pass is
    clamped to at least halve the rows (with tm == sublane and
    max_blocks >= tiles, a pass would otherwise give every tile its own
    partial block and never shrink)."""
    while (partials.shape[0] > max(cpu_thresh, 1)
           and partials.shape[0] > sublanes_for(partials.dtype)):
        sub2 = sublanes_for(partials.dtype)
        mb2 = max(1, min(max_blocks, partials.shape[0] // (2 * sub2)))
        tm2, p2, t2 = choose_tiling(partials.numel(), threads, mb2,
                                    partials.dtype)
        x2 = stage_padded(partials, tm2, p2, t2, op)
        partials = two_pass_call(x2, op, tm2, p2, t2)
    return partials


def finish(partials: torch.Tensor, op: ReduceOpSpec) -> torch.Tensor:
    """Reduce an accumulator or partials block (at most a few thousand
    elements) to a 0-d tensor on its device."""
    return op.reduce(partials)


def host_finish(partials: torch.Tensor, op: ReduceOpSpec):
    """--cpufinal: fetch the partials and finish with the host combine."""
    return op.np_reduce(host_value(partials))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _device_fn(kernel: int, op: ReduceOpSpec, tm: int, p: int, t: int,
               threads: int, max_blocks: int, cpu_thresh: int):
    """The device-only accumulator function of a kernel id."""
    if kernel == KERNEL_SINGLE_PASS:
        return lambda x2d: single_pass_call(x2d, op)
    if kernel == KERNEL_TWO_PASS:
        return lambda x2d: _multipass_finish(
            two_pass_call(x2d, op, tm, p, t), op, threads, max_blocks,
            cpu_thresh)
    if kernel in NOT_PORTED_KERNELS:
        raise NotImplementedError(not_ported_message(kernel))
    raise ValueError(f"kernel {kernel} is not live; only 6 and 7 run "
                     "(0-5 are WAIVED)")


def _make_staged_parts(method: str, n: int, dtype: DtypeLike, *,
                       threads: int, max_blocks: int, kernel: int,
                       cpu_thresh: int, device: Optional[torch.device]):
    op = get_op(method)
    tm, p, t = choose_tiling(n, threads, max_blocks, dtype)

    def stage_fn(x):
        return stage_padded(x, tm, p, t, op, device)

    return op, stage_fn, _device_fn(kernel, op, tm, p, t, threads,
                                    max_blocks, cpu_thresh)


def make_staged_reduce(method: str, n: int, dtype: DtypeLike, *,
                       threads: int = 256, max_blocks: int = 64,
                       kernel: int = KERNEL_SINGLE_PASS,
                       cpu_final: bool = False, cpu_thresh: int = 1,
                       device: Optional[torch.device] = None):
    """(stage_fn, reduce_fn): `stage_fn` pads and copies the host payload
    to `device` once, outside the timed loop; `reduce_fn` maps the staged
    tensor to the result (a 0-d device tensor, or a host scalar with
    cpu_final)."""
    op, stage_fn, device_fn = _make_staged_parts(
        method, n, dtype, threads=threads, max_blocks=max_blocks,
        kernel=kernel, cpu_thresh=cpu_thresh, device=device)
    if cpu_final:
        return stage_fn, lambda x2d: host_finish(device_fn(x2d), op)
    return stage_fn, lambda x2d: finish(device_fn(x2d), op)


def make_staged_core(method: str, n: int, dtype: DtypeLike, *,
                     threads: int = 256, max_blocks: int = 64,
                     kernel: int = KERNEL_SINGLE_PASS, cpu_thresh: int = 1,
                     device: Optional[torch.device] = None):
    """(op, stage_fn, core) with `core(x2d)` a 0-d tensor computed on the
    device alone: the chainable form ops/chain.py consumes."""
    op, stage_fn, device_fn = _make_staged_parts(
        method, n, dtype, threads=threads, max_blocks=max_blocks,
        kernel=kernel, cpu_thresh=cpu_thresh, device=device)
    return op, stage_fn, lambda x2d: finish(device_fn(x2d), op)


def target_device(x: torch.Tensor,
                  device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: `device` when given, else x's
    own CUDA device, else the card (which must exist)."""
    if device is None and x.device.type == "cuda":
        return x.device
    target = torch.device("cuda" if device is None else device)
    if target.type != "cuda":
        return target
    return device_mod.resolve("gpu", target.index)


def kernel_reduce(x: torch.Tensor, method: str, *, threads: int = 256,
                  max_blocks: int = 64, kernel: int = KERNEL_SINGLE_PASS,
                  cpu_final: bool = False, cpu_thresh: int = 1,
                  device: Union[str, torch.device, None] = None):
    """Reduce a flat tensor to a scalar with k6 or k7, staging included."""
    target = target_device(x, device)
    stage_fn, reduce_fn = make_staged_reduce(
        method, x.numel(), x.dtype, threads=threads, max_blocks=max_blocks,
        kernel=kernel, cpu_final=cpu_final, cpu_thresh=cpu_thresh,
        device=target)
    return reduce_fn(stage_fn(x))
