"""Single-chip reduction kernels k6-k10: staging, wrappers, plain
versions and the multi-pass finish.

The counterpart of tpu_reductions/ops/pallas_reduce.py:1. The payload is
staged once, untimed, into an identity-padded (P*T*TM, 128) tensor on the
device (`choose_tiling`, `stage_padded`: --threads sets the TM tile rows,
--maxblocks the P partial blocks). Then:

  k6  single_pass_call -> one (sub, 128) accumulator, finished to a scalar;
  k7  two_pass_call    -> (P*sub, 128) partials, relaunched on its own
                          partials (as they are, not re-staged) by
                          _multipass_finish while more than --cputhresh
                          rows remain, then finished on the device or,
                          with --cpufinal, on the host;
  k8  elementwise_call -> one (TM, 128) accumulator, in one launch;
  k9  mxu_call         -> (8, 128): row 0 the column sums (SUM over float
                          dtypes only, on the tensor cores), rows 1-7 zero;
  k10 stream_call      -> k8's (TM, 128) accumulator, its input streamed
                          through a --streambuffers-deep copy pipeline.

sub is 8 rows, or 16 for bf16. Slot (r, c) of a (sub, 128) block is the
combine, over the rows the block covers that are congruent to r modulo
sub, of column c; slot (r, c) of k8's and k10's (TM, 128) accumulator is
the combine over all staged rows congruent to r modulo TM. Neither
definition depends on the launch geometry, so the CUDA kernels
(csrc/reduce.cu, csrc/accumulate.cu) are free to pick their own and still
equal the JAX kernels element by element for int32 and MIN/MAX.

Each wrapper takes its plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel (or raises), and counts the
launch in its `launches` attribute.
"""

from __future__ import annotations

import dataclasses
import functools
from threading import enumerate as live_threads, get_ident
from typing import Optional, Union

import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import (KERNEL_ELEMENTWISE, KERNEL_MXU,
                                         KERNEL_SINGLE_PASS, KERNEL_STREAM,
                                         KERNEL_TWO_PASS, STREAM_BUFFERS)
from tpu_reductions_torch.obs import spans
from tpu_reductions_torch.ops import _cuda
from tpu_reductions_torch.ops.oracle import host_value
from tpu_reductions_torch.ops.registry import (ReduceOpSpec, accum_dtype,
                                               get_op, torch_dtype)
from tpu_reductions_torch.utils.staging import maybe_chunked_stage

LANES = 128      # row width of the staged layout (the TPU's lane count)
MXU_ACC_ROWS = 8    # k9's accumulator rows (the JAX kernel's, bf16 too)
# k10's shared-memory ring: the bytes one Hopper block can use (227 KB),
# the most stages its barrier arrays hold (csrc/accumulate.cu MAX_STAGES)
# and their bytes (a full and an empty mbarrier per stage), and the bytes
# one stage carries (whole SUB x 128 chunks of consecutive tiles)
SMEM_PER_BLOCK = 232448
STREAM_MAX_STAGES = 64
STREAM_BARRIER_BYTES = 2 * 8 * STREAM_MAX_STAGES
STREAM_STAGE_BYTES = 8192
# the warps of one k9 block (csrc/mxu.cu WARPS), and the rows of one
# slab, the K of its mma.sync shape, by dtype
MXU_WARPS = 16
MXU_SLAB_ROWS = {torch.bfloat16: 16, torch.float32: 8, torch.float64: 4}

DtypeLike = Union[str, torch.dtype]


def sublanes_for(dtype: DtypeLike) -> int:
    """Accumulator rows by element width: 8 for 32- and 64-bit types, 16
    for bf16 (the JAX package's sublane tiling).
    The counterpart of tpu_reductions/ops/pallas_reduce.py:77."""
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    return {8: 8, 4: 8, 2: 16, 1: 32}[dtype.itemsize]


def _acc_dtype(in_dtype: torch.dtype, op: ReduceOpSpec) -> torch.dtype:
    """f32 for bf16 SUM, the input dtype otherwise."""
    return accum_dtype(in_dtype) if op.name == "SUM" else in_dtype


def choose_tiling(n: int, threads: int = 256, max_blocks: int = 64,
                  dtype: DtypeLike = torch.float32) -> tuple[int, int, int]:
    """(TM tile rows, P partial blocks, T tiles per block) for n elements,
    with P*T*TM*128 >= n and TM a multiple of the dtype's sublane count.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:93."""
    sub = sublanes_for(dtype)
    rows = -(-n // LANES)
    tm = max(sub, min(int(threads), 2048))
    tm -= tm % sub
    num_tiles = -(-rows // tm)
    p = max(1, min(int(max_blocks), num_tiles))
    t = -(-num_tiles // p)
    return tm, p, t


def padded_2d_shape(n: int, tm: int, p: int, t: int) -> tuple[int, int]:
    """(rows, LANES) layout of n elements under the (tm, p, t) tiling.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:113."""
    return (p * t * tm, LANES)


def stage_padded(x: torch.Tensor, tm: int, p: int, t: int, op: ReduceOpSpec,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Copy a flat payload into a (P*T*TM, 128) tensor on `device` (x's
    own by default), padded with the op's identity. A host payload above
    the staging threshold goes in bounded chunks
    (utils/staging.maybe_chunked_stage), with the same result.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:120."""
    flat = x.reshape(-1)
    device = flat.device if device is None else device
    rows, lanes = padded_2d_shape(flat.numel(), tm, p, t)
    staged = maybe_chunked_stage(flat, rows, lanes, op.identity(flat.dtype),
                                 device)
    if staged is not None:
        return staged
    out = torch.full((rows * lanes,), op.identity(flat.dtype),
                     dtype=flat.dtype, device=device)
    out[:flat.numel()].copy_(flat)
    return out.view(rows, lanes)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def single_pass_plain(x2d: torch.Tensor, op: ReduceOpSpec) -> torch.Tensor:
    """k6's function in PyTorch: the (sub, 128) accumulator of all rows.
    The function of tpu_reductions/ops/pallas_reduce.py:390."""
    sub = sublanes_for(x2d.dtype)
    return op.reduce_dim(x2d.reshape(-1, sub, LANES), 0)


def _check_tiling(x2d: torch.Tensor, tm: int, p: int, t: int) -> None:
    """k7 takes at most the P*T*TM rows its tiling covers."""
    if x2d.shape[0] > p * t * tm:
        raise ValueError(f"k7 takes at most {p * t * tm} rows for tiling "
                         f"({tm}, {p}, {t}), got {x2d.shape[0]}")


def two_pass_plain(x2d: torch.Tensor, op: ReduceOpSpec, tm: int, p: int,
                   t: int) -> torch.Tensor:
    """k7's function in PyTorch: block i's (sub, 128) partial of its rows
    [i*T*TM, (i+1)*T*TM), stacked to (P*sub, 128). Rows that the tiling
    covers past the end of x2d read as the op's identity: they are padded
    here, as stage_padded would pad them.
    The function of tpu_reductions/ops/pallas_reduce.py:404."""
    _check_tiling(x2d, tm, p, t)
    sub = sublanes_for(x2d.dtype)
    missing = p * t * tm - x2d.shape[0]
    if missing:
        x2d = torch.cat([x2d, torch.full((missing, LANES),
                                         op.identity(x2d.dtype),
                                         dtype=x2d.dtype, device=x2d.device)])
    parts = op.reduce_dim(x2d.reshape(p, t * tm // sub, sub, LANES), 1)
    return parts.reshape(p * sub, LANES)


def elementwise_plain(x2d: torch.Tensor, op: ReduceOpSpec,
                      tm: int) -> torch.Tensor:
    """k8's and k10's function in PyTorch: the (TM, 128) accumulator whose
    slot (r, c) combines the rows congruent to r modulo TM of column c.
    The function of tpu_reductions/ops/pallas_reduce.py:227 and
    tpu_reductions/ops/pallas_reduce.py:338."""
    return op.reduce_dim(x2d.reshape(-1, tm, LANES), 0)


stream_plain = elementwise_plain   # k10 computes k8's function


def mxu_plain(x2d: torch.Tensor) -> torch.Tensor:
    """k9's function in PyTorch: an (8, 128) block in the accumulator
    dtype, row 0 the column sums, rows 1-7 zero.
    The function of tpu_reductions/ops/pallas_reduce.py:240."""
    acc = accum_dtype(x2d.dtype)
    out = torch.zeros((MXU_ACC_ROWS, LANES), dtype=acc, device=x2d.device)
    out[0] = x2d.to(acc).sum(0)
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# k6's and k7's pass (csrc/reduce.cu fold_span): CTAs of 512 threads, in
# thread-block clusters of at most CLUSTER CTAs (the portable limit). A
# CTA keeps 8 loads of 16 bytes in flight per thread (64 KiB), so about 64
# CTAs, one per two SMs, read at the card's full rate; more only lengthen
# the fold, and a cluster launch costs about a microsecond more than a
# plain one (bench/passes.py --sweep, PERF.md). So the planners fill half
# the SMs, split a span over a cluster only when its partial blocks alone
# would not, and never give a CTA a share of fewer than MIN_GROUPS
# sub-row groups.
CLUSTER = 8
MIN_GROUPS = 64


@dataclasses.dataclass(frozen=True)
class SpanPlan:
    """The geometry of one fold_span pass: `blocks` partial blocks, block
    i folding rows [i*span, (i+1)*span) with one cluster of `cluster`
    CTAs, of which rank s takes rows [i*span + s*share, +share) of that
    span (both bounded by the block's span and by the array).
    The card's form of the (P, T) grid of
    tpu_reductions/ops/pallas_reduce.py:404."""
    blocks: int
    cluster: int
    span: int
    share: int


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    return 1 << (max(1, v) - 1).bit_length()


def _fill(sm_count: int, active_clusters: int) -> int:
    """The CTAs a pass aims for: half the SMs, in whole clusters, within
    one wave of resident clusters."""
    if active_clusters < 1:
        raise ValueError("the device holds no cluster of k6/k7's CTAs")
    return max(CLUSTER, min(sm_count // 2, active_clusters * CLUSTER)
               // CLUSTER * CLUSTER)


def _plan(blocks: int, cluster: int, span: int, sub: int) -> SpanPlan:
    """Cut each span into `cluster` shares of whole sub-row groups."""
    return SpanPlan(blocks, cluster, span,
                    -(-(span // sub) // cluster) * sub)


def plan_k6(rows: int, sub: int, sm_count: int,
            active_clusters: int) -> SpanPlan:
    """k6's pass 1: as many CTAs as fill the card (_fill), but none with
    fewer than MIN_GROUPS groups, in clusters of up to CLUSTER, each
    cluster folding an equal run of whole groups (none empty) into one
    partial. A function of the shape and the device alone, so one shape
    always folds in one order.
    The grid of tpu_reductions/ops/pallas_reduce.py:390 on the card."""
    groups = rows // sub
    ctas = max(1, min(_fill(sm_count, active_clusters),
                      groups // MIN_GROUPS))
    cluster = min(CLUSTER, _pow2_floor(ctas))
    per_block = -(-groups // (ctas // cluster))
    return _plan(-(-groups // per_block), cluster, per_block * sub, sub)


def plan_k7(rows: int, sub: int, p: int, span: int, sm_count: int,
            active_clusters: int) -> SpanPlan:
    """k7's pass over `rows` rows under a tiling of P blocks of `span`
    (T*TM) rows: P clusters of S CTAs, S the least power of two (at most
    CLUSTER) for which P*S fills the card (_fill), cut back while a
    share would hold fewer than MIN_GROUPS groups. So P*S is within one
    wave of resident CTAs, or S = 1.
    The grid of tpu_reductions/ops/pallas_reduce.py:404 on the card."""
    fill = _fill(sm_count, active_clusters)
    if rows > p * span or span % sub:
        raise ValueError(f"k7 cannot cover {rows} rows with {p} blocks of "
                         f"{span} rows of {sub}-row groups")
    cluster = min(CLUSTER, _pow2_ceil(-(-fill // p)),
                  _pow2_floor(span // sub // MIN_GROUPS))
    while cluster > 1 and p * cluster > active_clusters * CLUSTER:
        cluster //= 2
    return _plan(p, cluster, span, sub)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _active_clusters(device: torch.device, op_name: str,
                     dtype: torch.dtype) -> int:
    return _cuda.span_active_clusters(device, CLUSTER, op_name, dtype)


def _check_staged(x2d: torch.Tensor, sub: int, kind: str = "cuda") -> None:
    """Refuse what the CUDA kernels do not take (`kind`, the card's device
    type, is another only for a test's fake card)."""
    if x2d.device.type != kind:
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


class K6Binding:
    """k6 bound to one staged shape, dtype and device, for one op, on
    `card` (_cuda.Card): the checks, plan_k6 and the accumulator's dtype
    done once, the launch's arguments converted once (_cuda.k6_args).
    `call` launches k6 into a fresh `out` and `partials`, or into a pair
    it keeps per stream and host thread. A kept pair is reused in stream
    order only: each call's finish reads `out` before the next call's k6
    on that stream writes it, and two streams or two threads never share
    a pair. A new pair first drops the pairs of threads that have ended,
    so the pairs kept are at most one per live thread and stream it
    reduced on.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:390."""

    __slots__ = ("key", "sub", "plan", "acc", "index", "card", "args",
                 "kept")

    def __init__(self, x2d: torch.Tensor, op: ReduceOpSpec, card) -> None:
        sub = sublanes_for(x2d.dtype)
        _check_staged(x2d, sub, card.kind)
        _check_aligned(x2d)
        self.plan = plan_k6(x2d.shape[0], sub, _sm_count(x2d.device),
                            _active_clusters(x2d.device, op.name, x2d.dtype))
        self.key = (x2d.shape, x2d.dtype, x2d.device)
        self.sub, self.acc = sub, _acc_dtype(x2d.dtype, op)
        self.index, self.card = x2d.device.index, card
        self.args = _cuda.k6_args(x2d.shape[0], self.plan, op.name,
                                  x2d.dtype)
        self.kept = {}

    def takes(self, x2d: torch.Tensor) -> bool:
        """Whether x2d has the bound shape, dtype and device, is
        contiguous and aligned, and its stream is not capturing a graph
        (whose allocations belong to the graph's pool): the card's form
        of the shape and dtype that key the jitted program of
        tpu_reductions/ops/pallas_reduce.py:589."""
        return ((x2d.shape, x2d.dtype, x2d.device) == self.key
                and x2d.is_contiguous() and not x2d.data_ptr() % 16
                and not self.card.capturing())

    def fresh(self) -> tuple:
        """(out, partials, out's address, partials' address): k6's
        (sub, 128) accumulator and its pass 1 partials, `out` itself
        where one partial block is all.
        The outputs of tpu_reductions/ops/pallas_reduce.py:390."""
        device = self.key[2]
        out = torch.empty((self.sub, LANES), dtype=self.acc, device=device)
        partials = (torch.empty((self.plan.blocks * self.sub, LANES),
                                dtype=self.acc, device=device)
                    if self.plan.blocks > 1 else out)
        return out, partials, out.data_ptr(), partials.data_ptr()

    def renew(self) -> tuple:
        """A fresh pair to keep, once the pairs of ended threads are
        dropped (their streams' work on them precedes any later call on
        those streams, as a dropped fresh pair's does).
        The outputs of tpu_reductions/ops/pallas_reduce.py:390, kept."""
        live = {t.ident for t in live_threads()}
        for at in list(self.kept):
            if at[1] not in live:
                self.kept.pop(at, None)
        return self.fresh()

    def call(self, x2d: torch.Tensor, rec: Optional[spans.HotRecord],
             keep: bool) -> torch.Tensor:
        """Launch k6 on x2d, a tensor of the bound kind, on the current
        stream, into the stream's and thread's kept pair (`keep`) or a
        fresh one, and return `out`. `rec`, the reduce call's open span
        record, takes the ends of its plan, scratch and launch.
        The counterpart of tpu_reductions/ops/pallas_reduce.py:390."""
        if rec is not None:
            rec.mark(spans.PLAN_END)
        card = self.card
        stream = card.stream(self.index)
        if keep:
            at = (stream, get_ident())
            pair = self.kept.get(at)
            if pair is None:
                pair = self.kept[at] = self.renew()
        else:
            pair = self.fresh()
        if rec is not None:
            rec.mark(spans.ALLOC_END)
        if card.device() == self.index:
            _cuda.k6_reduce(x2d.data_ptr(), pair[3], pair[2], self.args,
                            stream)
        else:
            with card.guard(self.index):
                _cuda.k6_reduce(x2d.data_ptr(), pair[3], pair[2],
                                self.args, stream)
        if rec is not None:
            rec.mark(spans.LAUNCH_END)
        single_pass_call.launches += 1
        return pair[0]


def single_pass_call(x2d: torch.Tensor, op: ReduceOpSpec,
                     rec: Optional[spans.HotRecord] = None) -> torch.Tensor:
    """k6: the (sub, 128) accumulator of a staged tensor, a fresh one each
    call; replaces the JAX package's single_pass_call. Bound by the bytes
    it reads. Pass 1 folds the rows with deep 16-byte loads over about
    one CTA per two SMs, in thread-block clusters that fold their CTAs'
    slots over distributed shared memory into one partial each (plan_k6);
    pass 2 folds those few partials over sub CTAs, one per slot row. No
    float atomics, so a tensor gives the same bits on every call. Both
    passes count as one launch. A one-call K6Binding: make_staged_reduce's
    reduce_fn keeps its binding instead (StagedK6). `rec`, the reduce
    call's open span record, takes the ends of its plan, allocations and
    launch.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:390."""
    if x2d.device.type == "cpu":
        return single_pass_plain(x2d, op)
    b = K6Binding(x2d, op, _cuda.card())
    return b.call(x2d, rec, False)


single_pass_call.launches = 0


class StagedK6:
    """make_staged_reduce's k6: the first tensor off the CPU binds
    (K6Binding; a tensor the kernels refuse raises as single_pass_call
    does); a tensor the binding takes then takes the bound launch, into
    scratch kept per stream and thread; any other goes through
    single_pass_call. Each call off the CPU counts in spans.K6_BOUND.
    reduce_fn's answer is finish's fresh 0-d tensor (or a host scalar),
    never the kept `out`.
    The k6 device call of tpu_reductions/ops/pallas_reduce.py:589."""

    __slots__ = ("op", "binding")

    def __init__(self, op: ReduceOpSpec) -> None:
        self.op, self.binding = op, None

    def call(self, x2d: torch.Tensor,
             rec: Optional[spans.HotRecord] = None) -> torch.Tensor:
        """k6's accumulator of x2d (a host tensor's by the plain
        version); `rec` as single_pass_call's.
        The counterpart of tpu_reductions/ops/pallas_reduce.py:390."""
        b = self.binding
        if b is not None and b.takes(x2d):
            spans.K6_BOUND.hits += 1
            return b.call(x2d, rec, True)
        if x2d.device.type == "cpu":
            return single_pass_plain(x2d, self.op)
        if b is None:
            b = K6Binding(x2d, self.op, _cuda.card())
            self.binding = b
            spans.K6_BOUND.binds += 1
            return b.call(x2d, rec, not b.card.capturing())
        spans.K6_BOUND.misses += 1
        return single_pass_call(x2d, self.op, rec)


def two_pass_call(x2d: torch.Tensor, op: ReduceOpSpec, tm: int, p: int,
                  t: int) -> torch.Tensor:
    """k7: the (P*sub, 128) partials of a staged tensor of at most P*T*TM
    rows (rows past its end read as the op's identity); replaces the JAX
    package's two_pass_call. Bound by the bytes it reads. Each partial
    block is folded with deep 16-byte loads by one thread-block cluster
    of S CTAs, S > 1 only where P blocks alone would leave the card
    short (plan_k7); the cluster folds its CTAs' slots in rank order over
    distributed shared memory, with no float atomics, so a tensor gives
    the same bits on every call.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:404."""
    _check_tiling(x2d, tm, p, t)
    if x2d.device.type == "cpu":
        return two_pass_plain(x2d, op, tm, p, t)
    sub = sublanes_for(x2d.dtype)
    _check_staged(x2d, sub)
    _check_aligned(x2d)
    plan = plan_k7(x2d.shape[0], sub, p, t * tm, _sm_count(x2d.device),
                   _active_clusters(x2d.device, op.name, x2d.dtype))
    out = torch.empty((p * sub, LANES), dtype=_acc_dtype(x2d.dtype, op),
                      device=x2d.device)
    _cuda.k7_reduce(x2d, out, plan, op.name)
    two_pass_call.launches += 1
    return out


two_pass_call.launches = 0


def _check_period(x2d: torch.Tensor, tm: int) -> None:
    """k8 and k10 take whole (TM, 128) tiles (JAX's stream_call refuses
    the rest too): a ragged tail would be dropped."""
    if tm <= 0 or x2d.shape[0] % tm:
        raise ValueError(f"k8/k10 need rows % tm == 0, got {x2d.shape[0]} "
                         f"rows with tm={tm}")


def plan_splits(tiles: int, tm: int, sub: int, sm_count: int) -> int:
    """k8's and k10's splits: block (g, s) of the tm/sub slot groups x
    splits grid folds slot group g of the tiles s, s + splits, ... in
    increasing order, and the splits are then folded in order. As many
    splits as keep the grid at two blocks per SM, at most one per tile. A
    function of the shape and the SM count alone: k8 and k10 take the
    same, so they add in the same order.
    The grid of tpu_reductions/ops/pallas_reduce.py:204 on the card."""
    return max(1, min(tiles, 2 * sm_count // (tm // sub)))


# k8 (csrc/accumulate.cu fold_period): the tiles a block loads before it
# combines them (16 bytes a thread each; the kernel has 4, 8 and 16), and
# the most splits whose partials the last block of each slot group folds
# in the same launch; above it a second launch folds them. On an H100
# (bench/passes.py --sweep, PERF.md) 4, 8 and 16 read within 0.5 us of
# each other (at 16 ptxas combines before its last loads are issued), and
# one launch was no slower than two at 33 splits for any dtype, but
# slower for f64 and bf16 at 66 and above.
K8_UNROLL = 8
K8_UNROLLS = (4, 8, 16)
K8_MAX_FUSED_SPLITS = 33


@dataclasses.dataclass(frozen=True)
class PeriodPlan:
    """k8's launch: plan_splits' grid, `unroll` tiles loaded before they
    are combined, and `fused`: whether the last block of each slot group
    folds the splits (one launch) or a second launch does. Both fold the
    splits in order from the identity, so both give the same bits.
    The grid of tpu_reductions/ops/pallas_reduce.py:227 on the card."""
    splits: int
    unroll: int
    fused: bool


def plan_k8(tiles: int, tm: int, sub: int, sm_count: int) -> PeriodPlan:
    """k8's geometry: plan_splits' grid, so the order of adds is k10's,
    K8_UNROLL, and one launch up to K8_MAX_FUSED_SPLITS splits. A
    function of the shape and the SM count alone.
    The grid of tpu_reductions/ops/pallas_reduce.py:227 on the card."""
    splits = plan_splits(tiles, tm, sub, sm_count)
    return PeriodPlan(splits, K8_UNROLL, splits <= K8_MAX_FUSED_SPLITS)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """k10's launch (csrc/accumulate.cu stream_period): plan_splits'
    grid and a ring of `depth` stages of `chunks` consecutive chunks of
    the block's split each.
    The card's form of the copy ring of
    tpu_reductions/ops/pallas_reduce.py:283."""
    splits: int
    depth: int
    chunks: int


def _stream_ring(chunk: int) -> tuple[int, int]:
    """(chunks a stage, the deepest ring) of k10 for SUB x 128 chunks of
    `chunk` bytes: whole chunks up to STREAM_STAGE_BYTES a stage, and as
    many stages as fit beside the barriers in one block's shared
    memory."""
    chunks = max(1, STREAM_STAGE_BYTES // chunk)
    return chunks, min(STREAM_MAX_STAGES,
                       (SMEM_PER_BLOCK - STREAM_BARRIER_BYTES)
                       // (chunks * chunk))


def plan_k10(tiles: int, tm: int, sub: int, itemsize: int, depth: int,
             sm_count: int) -> StreamPlan:
    """k10's geometry: k8's grid (plan_splits), so the order of adds is
    k8's, and _stream_ring's stages. Raises when the ring does not fit
    one block's shared memory beside its barriers; never clamps the
    depth.
    The grid of tpu_reductions/ops/pallas_reduce.py:338 on the card."""
    chunk = sub * LANES * itemsize
    chunks, deepest = _stream_ring(chunk)
    if depth > deepest:
        raise ValueError(
            f"kernel 10 cannot run {depth} stages: each stage holds "
            f"{chunks} chunk(s) of {chunk} B, and at most {deepest} stages "
            f"fit beside the barriers in the {SMEM_PER_BLOCK} B of shared "
            f"memory one block can use")
    return StreamPlan(plan_splits(tiles, tm, sub, sm_count), depth, chunks)


@dataclasses.dataclass(frozen=True)
class MxuPlan:
    """k9's pass 1 (csrc/mxu.cu mxu_columns): warp w of `blocks` blocks of
    MXU_WARPS warps folds slabs [w*run, (w+1)*run), cut at the last
    slab.
    The grid of tpu_reductions/ops/pallas_reduce.py:240 on the card."""
    run: int
    blocks: int


def plan_k9(slabs: int, sm_count: int) -> MxuPlan:
    """Equal contiguous runs of slabs over at most one block of MXU_WARPS
    warps per SM (one wave): the shortest run that the resident warps
    cover, then as few warps as that run needs, so only the last run may
    be shorter. A function of the slab count and the SM count alone.
    The grid of tpu_reductions/ops/pallas_reduce.py:240 on the card."""
    run = max(1, -(-slabs // (sm_count * MXU_WARPS)))
    return MxuPlan(run, max(1, -(-slabs // (run * MXU_WARPS))))


def _period_sub(x2d: torch.Tensor, tm: int) -> int:
    """The rows of a slot group of a staged tensor that k8 or k10 take;
    raises on what they do not."""
    sub = sublanes_for(x2d.dtype)
    _check_staged(x2d, sub)
    _check_aligned(x2d)
    if tm % sub:
        raise ValueError(f"tm={tm} is not a multiple of {sub} rows")
    return sub


def _period_buffers(x2d: torch.Tensor, op: ReduceOpSpec, tm: int,
                    splits: int):
    """(out, partials) of a k8 or k10 launch of `splits` splits. With one
    split, pass 1 writes `out`."""
    acc = _acc_dtype(x2d.dtype, op)
    out = torch.empty((tm, LANES), dtype=acc, device=x2d.device)
    partials = (torch.empty((splits * tm, LANES), dtype=acc,
                            device=x2d.device) if splits > 1 else out)
    return out, partials


# The tickets of one stream (csrc/common.cuh last_to_finish), which k8
# and dd share: one per slot group of the largest TM (2048 rows,
# choose_tiling's cap, in groups of 8 rows), then dd's pass 2's
TICKETS = 2048 // 8 + 1
_TICKETS: dict = {}


def _tickets(device: torch.device) -> torch.Tensor:
    """The tickets of the current stream of `device`: zeroed once, when
    the stream first launches k8 or dd, and left at zero by every launch
    (the last CTA of each ticket resets it). Launches in one stream run
    one after the other; two streams never share tickets."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    tickets = _TICKETS.get(key)
    if tickets is None:
        tickets = _TICKETS[key] = torch.zeros(TICKETS, dtype=torch.int32,
                                              device=device)
    return tickets


def _check_aligned(x2d: torch.Tensor) -> None:
    """The 16-byte loads of k6-k9 and k10's bulk copies need a 16-byte
    aligned base (rows are 256 bytes or more, so every row is
    then aligned)."""
    if x2d.data_ptr() % 16:
        raise ValueError("the staged tensor must start on a 16-byte "
                         "boundary")


def elementwise_call(x2d: torch.Tensor, op: ReduceOpSpec,
                     tm: int) -> torch.Tensor:
    """k8: the (TM, 128) accumulator of a staged tensor. Blocks of 256
    threads fold their tiles with 16-byte loads, K8_UNROLL deep, and the
    last block of each slot group folds the group's splits in the same
    launch (plan_k8; above K8_MAX_FUSED_SPLITS a second CUDA launch does).
    No float atomics: a tensor gives the same bits on every call, and
    k10's. Counts one launch a call.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:227."""
    _check_period(x2d, tm)
    if x2d.device.type == "cpu":
        return elementwise_plain(x2d, op, tm)
    sub = _period_sub(x2d, tm)
    plan = plan_k8(x2d.shape[0] // tm, tm, sub, _sm_count(x2d.device))
    out, partials = _period_buffers(x2d, op, tm, plan.splits)
    _cuda.k8_reduce(x2d, partials, out, _tickets(x2d.device), tm, plan,
                    op.name)
    elementwise_call.launches += 1
    return out


elementwise_call.launches = 0


def stream_max_depth(dtype: torch.dtype) -> int:
    """The deepest ring k10 can have for a dtype (_stream_ring).
    The bound on n_buffers of tpu_reductions/ops/pallas_reduce.py:338."""
    return _stream_ring(sublanes_for(dtype) * LANES * dtype.itemsize)[1]


def stream_call(x2d: torch.Tensor, op: ReduceOpSpec, tm: int,
                stream_buffers: int = STREAM_BUFFERS) -> torch.Tensor:
    """k10: k8's accumulator, with the input brought into shared memory
    by a `stream_buffers`-deep ring of bulk copies, issued by a producer
    warp and released stage by stage by the consumer warps (plan_k10).
    The depth moves copies, not the order of the adds: every depth gives
    the same bits, k8's. A depth that does not fit in shared memory
    raises; it is never clamped.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:338."""
    _check_period(x2d, tm)
    if stream_buffers <= 0:
        raise ValueError("stream_buffers must be positive")
    if x2d.device.type == "cpu":
        return stream_plain(x2d, op, tm)
    plan = plan_k10(x2d.shape[0] // tm, tm, _period_sub(x2d, tm),
                    x2d.element_size(), stream_buffers,
                    _sm_count(x2d.device))
    out, partials = _period_buffers(x2d, op, tm, plan.splits)
    _cuda.k10_reduce(x2d, partials, out, tm, plan, op.name)
    stream_call.launches += 1
    return out


stream_call.launches = 0


def mxu_call(x2d: torch.Tensor, op: ReduceOpSpec) -> torch.Tensor:
    """k9: SUM over float dtypes on the tensor cores, as an (8, 128)
    block: row 0 the column sums, rows 1-7 exactly zero. MIN/MAX have no
    product form and integers no exact one: both raise, and the driver
    WAIVEs those rows. The warps take equal runs of slabs (plan_k9), 16
    to an SM, so that some have loads in flight while others are in the
    tensor cores; no float atomics, so a tensor gives the same bits on
    every call. Its two CUDA passes count as one launch.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:240."""
    if op.name != "SUM":
        raise ValueError("kernel 9 (MXU) implements SUM only")
    if not x2d.dtype.is_floating_point:
        raise ValueError(f"kernel 9 (MXU) needs a float dtype, got "
                         f"{x2d.dtype}")
    if x2d.device.type == "cpu":
        return mxu_plain(x2d)
    _check_staged(x2d, sublanes_for(x2d.dtype))
    _check_aligned(x2d)
    plan = plan_k9(x2d.shape[0] // MXU_SLAB_ROWS[x2d.dtype],
                   _sm_count(x2d.device))
    acc = accum_dtype(x2d.dtype)
    partials = torch.empty((plan.blocks, LANES), dtype=acc,
                           device=x2d.device)
    out = torch.empty((MXU_ACC_ROWS, LANES), dtype=acc, device=x2d.device)
    _cuda.k9_reduce(x2d, partials, out, plan)
    mxu_call.launches += 1
    return out


mxu_call.launches = 0


def _multipass_finish(partials: torch.Tensor, op: ReduceOpSpec, threads: int,
                      max_blocks: int, cpu_thresh: int) -> torch.Tensor:
    """Relaunch k7 on its own partials while more than cpu_thresh rows
    remain and a further pass can shrink them. Two guards end the loop:
    the partials' own sublane count is the floor, and each pass is
    clamped to at least halve the rows (with tm == sublane and
    max_blocks >= tiles, a pass would otherwise give every tile its own
    partial block and never shrink). Each pass has the JAX chain's tiling
    and output shape, but takes the partials as they are: the rows its
    tiling counts past them read as the identity, where the JAX chain
    stages an identity-padded copy."""
    while (partials.shape[0] > max(cpu_thresh, 1)
           and partials.shape[0] > sublanes_for(partials.dtype)):
        sub2 = sublanes_for(partials.dtype)
        mb2 = max(1, min(max_blocks, partials.shape[0] // (2 * sub2)))
        tm2, p2, t2 = choose_tiling(partials.numel(), threads, mb2,
                                    partials.dtype)
        partials = two_pass_call(partials, op, tm2, p2, t2)
    return partials


def finish(partials: torch.Tensor, op: ReduceOpSpec) -> torch.Tensor:
    """Reduce an accumulator or partials block (at most a few thousand
    elements) to a 0-d tensor on its device.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:467."""
    return op.reduce(partials)


def host_finish(partials: torch.Tensor, op: ReduceOpSpec):
    """--cpufinal: fetch the partials and finish with the host combine.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:477."""
    return op.np_reduce(host_value(partials))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


# One kernel call per reduce, by kernel id, each called as
# (x2d, op, tm, stream_buffers, rec), rec the reduce call's open span
# record (obs/spans.py; None while the recorder is off), which k6 alone
# stamps; k7 (the multi-pass partials chain) is the only structure
# outside this map. k10's entry is the one place where the depth meets
# the dispatch, for every entry point.
SINGLE_INVOCATION_CALLS = {
    KERNEL_SINGLE_PASS: lambda x2d, op, tm, depth, rec: single_pass_call(
        x2d, op, rec),
    KERNEL_ELEMENTWISE: lambda x2d, op, tm, depth, rec: elementwise_call(
        x2d, op, tm),
    KERNEL_MXU: lambda x2d, op, tm, depth, rec: mxu_call(x2d, op),
    KERNEL_STREAM: lambda x2d, op, tm, depth, rec: stream_call(x2d, op, tm,
                                                               depth),
}


def _device_fn(kernel: int, op: ReduceOpSpec, tm: int, p: int, t: int,
               threads: int, max_blocks: int, cpu_thresh: int,
               stream_buffers: int, bind: bool = False):
    """The device-only accumulator function of a kernel id, called as
    (x2d) or (x2d, rec); k6's bound to its first staged tensor on the
    card with `bind` (StagedK6)."""
    if kernel == KERNEL_SINGLE_PASS and bind:
        k6 = StagedK6(op)
        return lambda x2d, rec=None: k6.call(x2d, rec)
    if kernel in SINGLE_INVOCATION_CALLS:
        call = SINGLE_INVOCATION_CALLS[kernel]
        return lambda x2d, rec=None: call(x2d, op, tm, stream_buffers, rec)
    if kernel == KERNEL_TWO_PASS:
        return lambda x2d, rec=None: _multipass_finish(
            two_pass_call(x2d, op, tm, p, t), op, threads, max_blocks,
            cpu_thresh)
    raise ValueError(f"kernel {kernel} is not live; only 6-10 run "
                     "(0-5 are WAIVED)")


def _make_staged_parts(method: str, n: int, dtype: DtypeLike, *,
                       threads: int, max_blocks: int, kernel: int,
                       cpu_thresh: int, stream_buffers: int,
                       device: Optional[torch.device], bind: bool = False):
    op = get_op(method)
    tm, p, t = choose_tiling(n, threads, max_blocks, dtype)

    def stage_fn(x):
        return stage_padded(x, tm, p, t, op, device)

    return op, stage_fn, _device_fn(kernel, op, tm, p, t, threads,
                                    max_blocks, cpu_thresh, stream_buffers,
                                    bind)


def make_staged_reduce(method: str, n: int, dtype: DtypeLike, *,
                       threads: int = 256, max_blocks: int = 64,
                       kernel: int = KERNEL_SINGLE_PASS,
                       cpu_final: bool = False, cpu_thresh: int = 1,
                       stream_buffers: int = STREAM_BUFFERS,
                       device: Optional[torch.device] = None):
    """(stage_fn, reduce_fn): `stage_fn` pads and copies the host payload
    to `device` once, outside the timed loop; `reduce_fn` maps the staged
    tensor to the result (a 0-d device tensor, fresh each call, or a host
    scalar with cpu_final). With k6, reduce_fn binds its launch to the
    first staged tensor it is given on the card (StagedK6): later calls
    with a tensor of that kind skip the checks, the plan and the
    allocations.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:589."""
    op, stage_fn, device_fn = _make_staged_parts(
        method, n, dtype, threads=threads, max_blocks=max_blocks,
        kernel=kernel, cpu_thresh=cpu_thresh, stream_buffers=stream_buffers,
        device=device, bind=True)
    fin = host_finish if cpu_final else finish
    k6 = kernel == KERNEL_SINGLE_PASS

    def reduce_fn(x2d):
        rec = spans.hot_begin()
        if rec is None:
            return fin(device_fn(x2d), op)
        # recorded (obs/spans.py): k6 on the card stamps its plan,
        # allocations and launch, every kernel its finish
        if k6 and x2d.device.type == "cuda":
            rec.plan()
        return spans.hot_call(rec, lambda: device_fn(x2d, rec),
                              lambda acc: fin(acc, op))

    return stage_fn, reduce_fn


def make_staged_core(method: str, n: int, dtype: DtypeLike, *,
                     threads: int = 256, max_blocks: int = 64,
                     kernel: int = KERNEL_SINGLE_PASS, cpu_thresh: int = 1,
                     stream_buffers: int = STREAM_BUFFERS,
                     device: Optional[torch.device] = None):
    """(op, stage_fn, core) with `core(x2d)` a 0-d tensor computed on the
    device alone: the chainable form ops/chain.py consumes.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:619."""
    op, stage_fn, device_fn = _make_staged_parts(
        method, n, dtype, threads=threads, max_blocks=max_blocks,
        kernel=kernel, cpu_thresh=cpu_thresh, stream_buffers=stream_buffers,
        device=device)
    return op, stage_fn, lambda x2d: finish(device_fn(x2d), op)


def target_device(x: torch.Tensor,
                  device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: `device` when given, else x's
    own CUDA device, else the card (which must exist).
    No reference analog: the JAX package runs on its default device."""
    if device is None and x.device.type == "cuda":
        return x.device
    target = torch.device("cuda" if device is None else device)
    if target.type != "cuda":
        return target
    return device_mod.resolve("gpu", target.index)


def kernel_reduce(x: torch.Tensor, method: str, *, threads: int = 256,
                  max_blocks: int = 64, kernel: int = KERNEL_SINGLE_PASS,
                  cpu_final: bool = False, cpu_thresh: int = 1,
                  stream_buffers: int = STREAM_BUFFERS,
                  device: Union[str, torch.device, None] = None):
    """Reduce a flat tensor to a scalar with one of k6-k10, staging
    included.
    The counterpart of tpu_reductions/ops/pallas_reduce.py:512."""
    target = target_device(x, device)
    stage_fn, reduce_fn = make_staged_reduce(
        method, x.numel(), x.dtype, threads=threads, max_blocks=max_blocks,
        kernel=kernel, cpu_final=cpu_final, cpu_thresh=cpu_thresh,
        stream_buffers=stream_buffers, device=target)
    return reduce_fn(stage_fn(x))
