"""Streaming reduction pipeline: double-buffered host-to-device staging
overlapped with accumulation on the device.

The counterpart of tpu_reductions/ops/stream.py:1. Instead of staging the
whole payload before the timed loop, the payload is cut into bounded
chunks (`plan_chunks`, at most config.stage_chunk_bytes each) and

  acc  = identity (8, 128) block, resident on the device
  d[0] = put(chunk 0)                     # copy in flight
  for i in chunks:
      d[i+1] = put(chunk i+1)             # the next copy starts
      acc    = fold(acc, d[i])            # while this fold runs
      every `sync_every` chunks:
          partial = acc on the host       # 4 KiB: the materialization,
                                          # the timing boundary and the
                                          # resume checkpoint

`put` is utils/staging.ChunkStager.put_chunk_async: a pinned host buffer
and a copy on a side stream, with events that keep the fold from reading
a chunk before its copy and the next copy from overwriting a chunk before
its fold. At most two chunks (plus the accumulator) are on the device.

The fold is plain torch, as the JAX package's is jnp: a chunk collapses to
one (8, 128) block along its leading axis and combines elementwise into
the accumulator. float64 streams as pairs on every platform, as there:
SUM as unscaled (hi, lo) float32 planes (a per-chunk scale could not be
combined across chunks, so |x| must stay under the float32 range),
MIN/MAX as int32 order keys, each folded by a halving tree of the
ops/dd_reduce transformations and finished with host_finish_pairs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import stage_chunk_bytes
from tpu_reductions_torch.ops import dd_reduce
from tpu_reductions_torch.ops.oracle import host_value
from tpu_reductions_torch.ops.registry import (TORCH_DTYPES, accum_dtype,
                                               get_op, torch_dtype)
from tpu_reductions_torch.utils.staging import ChunkStager

# the accumulator block (8, 128), and the alignment quantum of every chunk
_SUBLANES = 8
_LANES = 128
_BLOCK = _SUBLANES * _LANES


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """The chunk geometry of one streamed reduction; part of the resume
    contract (a partial checkpointed under one plan is never resumed
    under another).
    The counterpart of tpu_reductions/ops/stream.py:70."""

    n: int                 # payload elements
    dtype: str
    chunk_elems: int       # elements of a full chunk: a power-of-two
    #                        count of (8, 128) blocks
    num_chunks: int        # ceil(n / chunk_elems)
    chunk_bytes: int       # the bound chunk_elems was fit under

    @property
    def chunk_rows(self) -> int:
        """Rows of one staged (rows, 128) chunk.
        The counterpart of tpu_reductions/ops/stream.py:87."""
        return self.chunk_elems // _LANES

    def chunk_span(self, index: int) -> tuple[int, int]:
        """[start, end) of chunk `index`; the last one may be ragged (its
        staged tail is padded with the op's identity).
        The counterpart of tpu_reductions/ops/stream.py:92."""
        if not 0 <= index < self.num_chunks:
            raise IndexError(f"chunk {index} outside 0..{self.num_chunks}")
        start = index * self.chunk_elems
        return start, min(start + self.chunk_elems, self.n)


def plan_chunks(n: int, dtype: str, chunk_bytes: Optional[int] = None
                ) -> ChunkPlan:
    """The largest power-of-two count of (8, 128) blocks under the bound.
    float64 counts 4 bytes an element: it streams as two 32-bit planes,
    each of which keeps to the bound on its own.
    The counterpart of tpu_reductions/ops/stream.py:104."""
    if n <= 0:
        raise ValueError("n must be positive")
    bound = stage_chunk_bytes(chunk_bytes)
    itemsize = 4 if str(dtype) == "float64" else \
        torch_dtype(str(dtype)).itemsize
    blocks = max(1, bound // (itemsize * _BLOCK))
    blocks = 1 << (blocks.bit_length() - 1)          # floor to a power of 2
    chunk_elems = blocks * _BLOCK
    return ChunkPlan(n=n, dtype=str(dtype), chunk_elems=chunk_elems,
                     num_chunks=-(-n // chunk_elems), chunk_bytes=bound)


class StreamReducer:
    """The device half of the pipeline: a resident (8, 128) partial (a pair
    of blocks for float64) that chunks fold into, with checkpoint and
    restore at the fetched-partial grain. Drive it through `run_stream`.
    `slots` chunks can be on the device at once (two for the pipeline).
    The counterpart of tpu_reductions/ops/stream.py:183."""

    def __init__(self, method: str, dtype: str, n: int, *,
                 chunk_bytes: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 slots: int = 2) -> None:
        self.method = method.upper()
        self.dtype = str(dtype)
        self.op = get_op(self.method)
        self.plan = plan_chunks(n, self.dtype, chunk_bytes)
        self.is_dd = self.dtype == "float64"
        self.device = device_mod.resolve("gpu") if device is None else device
        self.slots = slots
        planes = ((dd_reduce.PLANE_DTYPES[self.method],) * 2 if self.is_dd
                  else (torch_dtype(self.dtype),))
        self.stager = ChunkStager(self.device, self.plan.chunk_rows, planes,
                                  slots=slots,
                                  chunk_bytes=self.plan.chunk_bytes)
        self._acc = None       # device block, or (hi, lo) blocks

    def _identity_partial(self):
        shape = (_SUBLANES, _LANES)
        if self.is_dd:
            dt = dd_reduce.PLANE_DTYPES[self.method]
            return tuple(torch.full(shape, v.item(), dtype=dt)
                         for v in dd_reduce.pad_pair(self.method))
        dt = torch_dtype(self.dtype)
        if self.method == "SUM":
            dt = accum_dtype(dt)
        return torch.full(shape, self.op.identity(dt), dtype=dt)

    def restore(self, partial=None) -> None:
        """Put a partial on the device: None is the op's identity (a fresh
        stream), else what an earlier partial() fetched (a resume).
        The counterpart of tpu_reductions/ops/stream.py:229."""
        if partial is None:
            partial = self._identity_partial()
        if self.is_dd:
            self._acc = tuple(p.to(self.device) for p in partial)
        else:
            self._acc = partial.to(self.device)

    def stage(self, flat: torch.Tensor, index: int):
        """Cut chunk `index` out of the flat host payload, pad a ragged
        tail with the identity (every chunk has the full shape), and start
        its copy. float64 is encoded into its two planes here.
        The counterpart of tpu_reductions/ops/stream.py:247."""
        start, end = self.plan.chunk_span(index)
        rows, elems = self.plan.chunk_rows, self.plan.chunk_elems
        piece = flat[start:end]
        if self.is_dd:
            x = piece.numpy()
            hi, lo = (dd_reduce.host_split(x) if self.method == "SUM"
                      else dd_reduce.host_key_encode(x))
            pads = dd_reduce.pad_pair(self.method)
            planes = [np.pad(p, (0, elems - x.size), constant_values=v)
                      if x.size < elems else p for p, v in zip((hi, lo), pads)]
            planes = [torch.from_numpy(p).view(rows, _LANES) for p in planes]
        else:
            if piece.numel() < elems:
                padded = torch.full((elems,), self.op.identity(piece.dtype),
                                    dtype=piece.dtype)
                padded[:piece.numel()] = piece
                piece = padded
            planes = [piece.view(rows, _LANES)]
        slot = index % self.slots
        return slot, self.stager.put_chunk_async(slot, planes)

    def fold(self, staged) -> None:
        """Fold one staged chunk into the resident partial (queued on the
        device; the next partial() fetch is its completion point).
        The counterpart of tpu_reductions/ops/stream.py:283."""
        assert self._acc is not None, "restore() before fold()"
        slot, planes = staged
        self.stager.acquire(slot)
        if self.is_dd:
            hi, lo = (p.view(-1, _SUBLANES, _LANES) for p in planes)
            hi, lo = dd_reduce.halving_tree(hi, lo, self.method)
            self._acc = dd_reduce.dd_combine(self.method)(*self._acc, hi, lo)
        else:
            acc = self._acc
            folded = self.op.reduce_dim(
                planes[0].view(-1, _SUBLANES, _LANES), 0)
            self._acc = self.op.combine(acc, folded.to(acc.dtype))
        self.stager.release(slot)

    def partial(self):
        """The running partial on the host (4 KiB, or two blocks).
        The counterpart of tpu_reductions/ops/stream.py:310."""
        assert self._acc is not None, "restore() before partial()"
        if self.is_dd:
            return tuple(p.cpu() for p in self._acc)
        return self._acc.cpu()

    def finish(self, partial=None):
        """The final scalar from a fetched partial: int32 SUM wraps modulo
        2^32 like the device accumulator, real SUM adds in float64, and
        float64 decodes through host_finish_pairs.
        The counterpart of tpu_reductions/ops/stream.py:326."""
        if partial is None:
            partial = self.partial()
        if self.is_dd:
            return dd_reduce.host_finish_pairs(*partial, self.method)
        block = host_value(partial)
        if self.method == "SUM":
            if block.dtype == np.int32:
                return np.int64(block.sum(dtype=np.int64)
                                ).astype(np.int32)[()]
            return np.float64(block.astype(np.float64).sum())
        return self.op.np_reduce(block)


def dtype_name(dtype: torch.dtype) -> str:
    """The config name of a torch dtype (`torch.int32` -> `int32`).
    No reference analog: numpy dtypes carry their names."""
    return str(dtype).removeprefix("torch.")


def partial_to_jsonable(partial) -> dict:
    """A fetched partial as JSON for the resume checkpoint; floats round
    trip exactly, int32 keys as ints.
    The counterpart of tpu_reductions/ops/stream.py:351."""
    planes = list(partial) if isinstance(partial, tuple) else [partial]
    return {"dtype": dtype_name(planes[0].dtype),
            "planes": [p.reshape(-1).tolist() for p in planes]}


def partial_from_jsonable(spec: dict):
    """The inverse of partial_to_jsonable: restore()'s input.
    The counterpart of tpu_reductions/ops/stream.py:365."""
    dt = TORCH_DTYPES[spec["dtype"]]
    planes = [torch.tensor(p, dtype=dt).reshape(_SUBLANES, _LANES)
              for p in spec["planes"]]
    return tuple(planes) if len(planes) == 2 else planes[0]


@dataclasses.dataclass
class StreamResult:
    """One streamed reduction: the scalar and the sustained rates. The
    wall clock runs from the first stage to the last materialization.
    The counterpart of tpu_reductions/ops/stream.py:377."""

    value: object                 # np scalar (np.float64 for float64)
    chunks_done: int
    num_chunks: int
    nbytes: int
    wall_s: float
    syncs: int
    resumed_from: int = 0         # the first chunk this run folded

    @property
    def gbps(self) -> float:
        """Sustained GB/s over the streamed span: copies and folds,
        overlapped; not a kernel rate.
        The counterpart of tpu_reductions/ops/stream.py:393."""
        return (self.nbytes / self.wall_s) / 1e9 if self.wall_s > 0 \
            else float("inf")

    @property
    def chunks_per_s(self) -> float:
        """Chunks folded per second by this run.
        The counterpart of tpu_reductions/ops/stream.py:401."""
        done = self.chunks_done - self.resumed_from
        return done / self.wall_s if self.wall_s > 0 else float("inf")


def run_stream(flat, method: str, *, chunk_bytes: Optional[int] = None,
               sync_every: int = 8, start_chunk: int = 0,
               init_partial=None, on_sync=None,
               reducer: Optional[StreamReducer] = None,
               device: Optional[torch.device] = None) -> StreamResult:
    """The double-buffered pipeline over a flat host payload (a CPU tensor
    or a numpy array). `on_sync(chunks_done, partial)` is called at every
    materialization; `start_chunk` and `init_partial` resume from such a
    checkpoint, and the chunks before it are never staged again. The
    folds run over the same chunk boundaries wherever a run starts, so a
    resumed stream's value is the uninterrupted one's, bit for bit. As
    in JAX, the `stream.chunk` fault point fires before each chunk and
    the `stream.*` events record the run.
    The counterpart of tpu_reductions/ops/stream.py:408."""
    flat = torch.as_tensor(flat).reshape(-1)
    r = reducer or StreamReducer(method, dtype_name(flat.dtype),
                                 flat.numel(), chunk_bytes=chunk_bytes,
                                 device=device)
    plan = r.plan
    if not 0 <= start_chunk <= plan.num_chunks:
        raise ValueError(f"start_chunk {start_chunk} outside plan "
                         f"(0..{plan.num_chunks})")
    sync_every = max(1, int(sync_every))
    from tpu_reductions_torch.exec import core as exec_core
    from tpu_reductions_torch.exec.plan import launch_plan
    from tpu_reductions_torch.faults.inject import fault_point
    from tpu_reductions_torch.obs import ledger, trace
    # one span per stream; the loop is one plan of the execution core
    # under the `stream` heartbeat phase, ticking per chunk and per sync
    with trace.child():
        ledger.emit("stream.start", method=r.method, dtype=r.dtype,
                    n=plan.n, nbytes=int(flat.numel() * flat.element_size()),
                    chunk_elems=plan.chunk_elems,
                    num_chunks=plan.num_chunks, start_chunk=start_chunk,
                    sync_every=sync_every)
        t0 = time.monotonic()
        partial = None
        syncs = 0

        def pipeline(ctx):
            nonlocal partial, syncs
            r.restore(init_partial)
            if start_chunk < plan.num_chunks:
                inflight = r.stage(flat, start_chunk)
            for i in range(start_chunk, plan.num_chunks):
                fault_point("stream.chunk")
                t_stage = time.monotonic()
                nxt = (r.stage(flat, i + 1) if i + 1 < plan.num_chunks
                       else None)
                t_fold = time.monotonic()
                r.fold(inflight)              # overlaps nxt's copy
                t_done = time.monotonic()
                inflight = nxt
                ctx.tick()
                done = i + 1
                # host-side dispatch seconds, not device times
                ledger.emit("stream.chunk", chunk=i, chunks_done=done,
                            total=plan.num_chunks,
                            stage_s=round(t_fold - t_stage, 6),
                            fold_s=round(t_done - t_fold, 6))
                if done % sync_every == 0 or done == plan.num_chunks:
                    partial = r.partial()     # the materialization
                    syncs += 1
                    ctx.tick()
                    ledger.emit("stream.sync", chunks_done=done,
                                total=plan.num_chunks,
                                elapsed_s=round(time.monotonic() - t0, 6))
                    if on_sync is not None:
                        on_sync(done, partial)
            if partial is None:               # resumed at the very end
                partial = r.partial()

        exec_core.run(launch_plan(
            "stream", "stream", pipeline, timing="stream",
            heartbeat_phase="stream",
            staging_bound=int(plan.chunk_bytes),
            method=r.method, dtype=r.dtype, n=plan.n,
            chunks=plan.num_chunks, start_chunk=start_chunk))
        wall = time.monotonic() - t0
        span = (plan.chunk_span(start_chunk)[0]
                if start_chunk < plan.num_chunks else plan.n)
        nbytes = (flat.numel() - span) * flat.element_size()
        res = StreamResult(value=r.finish(partial),
                           chunks_done=plan.num_chunks,
                           num_chunks=plan.num_chunks, nbytes=nbytes,
                           wall_s=wall, syncs=syncs,
                           resumed_from=start_chunk)
        ledger.emit("stream.end", chunks=plan.num_chunks,
                    resumed_from=start_chunk, wall_s=round(wall, 6),
                    gbps=round(res.gbps, 4),
                    chunks_per_s=round(res.chunks_per_s, 4))
    return res


def iter_chunks(flat, plan: ChunkPlan,
                start: int = 0) -> Iterator[torch.Tensor]:
    """The host chunks of `plan` from `start` on, as views (the
    incremental oracle's input).
    The counterpart of tpu_reductions/ops/stream.py:528."""
    flat = torch.as_tensor(flat).reshape(-1)
    for i in range(start, plan.num_chunks):
        s, e = plan.chunk_span(i)
        yield flat[s:e]
