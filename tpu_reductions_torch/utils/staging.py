"""Host-to-device staging in bounded chunks: a large payload's one-shot
staging, and the streaming pipeline's double-buffered chunks.

`maybe_chunked_stage` is the counterpart of the same function in
tpu_reductions/utils/staging.py. A payload above
`config.stage_threshold_bytes()` (by default twice the chunk bound, so a
chunked stage has at least two chunks to overlap) goes into an
identity-filled device tensor in row blocks of at most
`config.stage_chunk_bytes()`, the ragged tail last, through a
double-buffered `ChunkStager`: the host copies one block into a pinned
buffer while the previous block's transfer is in flight. The result is
the one-shot stage's, bit for bit. It is there for speed: on an H100
host (NVIDIA H100 80GB HBM3, 700.00 W) bench/host.py staged 4 GiB of
int32 at 5.49 GB/s in the one-shot pageable copy and at 16.18 GB/s in
256 MiB chunks through two slots (13.51-14.80 GB/s at 16 and 64 MiB, and
10.93-12.50 GB/s through one slot). Smaller payloads keep the one-shot
copy (None).

`ChunkStager` is the counterpart of `put_chunk_async` there.
There, `jax.device_put` returns on dispatch, so chunk i+1's transfer is in
flight while the device folds chunk i. Here a `ChunkStager` owns, for each
of its slots, a pinned host buffer and a device buffer per plane,
allocated once:

  put_chunk_async(slot, planes):
      wait on the host until the slot's previous copy has left its pinned
      buffer; copy the padded chunk into the pinned buffer; on a side
      stream, wait (on the card) until the fold that last read the slot's
      device buffer is done, then copy pinned -> device with
      non_blocking=True and record the slot's `ready` event;
  acquire(slot):  the fold's stream waits on `ready` before it reads;
  release(slot):  records, on the fold's stream, the event that frees the
                  slot's device buffer for the next copy.

So a pinned or device buffer is reused only after the event that frees it,
and a stream of any length holds `slots` chunks on the device. On the CPU
a put is a plain copy and the events do not exist.

Each put refuses a chunk larger than the per-chunk bound
(config.stage_chunk_bytes) beyond the JAX package's allowance: a chunk
padded up to whole (8, 128) blocks may exceed the bound by under eight
rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpu_reductions_torch.config import (stage_chunk_bytes,
                                         stage_threshold_bytes)
from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.obs import ledger, trace
from tpu_reductions_torch.utils import heartbeat


def device_put_chunked(flat: torch.Tensor, rows: int, lanes: int,
                       identity, device: torch.device, *,
                       chunk_bytes: Optional[int] = None,
                       slots: int = 2) -> torch.Tensor:
    """Stage the flat CPU payload `flat` as a (rows, lanes) tensor on
    `device` whose slots past the payload hold `identity`, in blocks of
    at most `stage_chunk_bytes(chunk_bytes)` (whole rows, at least one)
    through a `slots`-deep ChunkStager: the host copies block i+1 into
    one pinned buffer while block i's transfer is in flight. As in JAX,
    the blocks run under a `staging` heartbeat guard and one trace span
    (`staging.start`, a `staging.chunk` a block, `staging.end`), each
    block after the `staging.chunk` fault point and ticking the mark;
    an interrupted stage leaves no partial tensor to its caller."""
    if flat.numel() > rows * lanes:
        raise ValueError(f"payload {flat.numel()} > staged shape "
                         f"{rows}x{lanes}")
    out = torch.full((rows, lanes), identity, dtype=flat.dtype,
                     device=device)
    full_rows = flat.numel() // lanes
    step = max(1, stage_chunk_bytes(chunk_bytes)
               // (lanes * flat.element_size()))
    blocks = [(r, min(step, full_rows - r))
              for r in range(0, full_rows, step)]
    tail = flat[full_rows * lanes:]
    if tail.numel():
        blocks.append((full_rows, 1))
    stager = ChunkStager(device, max(1, min(step, full_rows)),
                         (flat.dtype,), slots=slots,
                         chunk_bytes=chunk_bytes, lanes=lanes)
    with trace.child():
        ledger.emit("staging.start",
                    nbytes=int(flat.numel() * flat.element_size()),
                    rows=rows, lanes=lanes,
                    chunk_bytes=int(stage_chunk_bytes(chunk_bytes)))
        # redlint: disable=RED025 -- utils/staging IS the chunked-transfer primitive a plan's staging delegates to; its per-chunk guard+tick granularity sits below LaunchPlan scope
        with heartbeat.guard("staging"):
            for i, (r, k) in enumerate(blocks):
                if r < full_rows:
                    fault_point("staging.chunk")
                    block = flat[r * lanes:(r + k) * lanes].view(k, lanes)
                else:
                    block = torch.full((1, lanes), identity,
                                       dtype=flat.dtype)
                    block[0, :tail.numel()] = tail
                slot = i % slots
                (staged,) = stager.put_chunk_async(slot, (block,))
                stager.acquire(slot)
                out[r:r + k].copy_(staged)
                stager.release(slot)
                heartbeat.tick()
                if r < full_rows:
                    ledger.emit("staging.chunk", row=r,
                                rows_done=min(r + k, full_rows),
                                total_rows=full_rows)
        ledger.emit("staging.end", rows=rows, lanes=lanes)
    return out


def maybe_chunked_stage(flat: torch.Tensor, rows: int, lanes: int,
                        identity, device: torch.device
                        ) -> Optional[torch.Tensor]:
    """device_put_chunked for a CPU payload above `stage_threshold_bytes()`;
    None for a smaller one or one already on a device (the caller keeps
    its one-shot copy)."""
    if flat.device.type != "cpu" or flat.numel() * flat.element_size() \
            <= stage_threshold_bytes():
        return None
    return device_put_chunked(flat.reshape(-1), rows, lanes, identity,
                              device)


def stage_flat(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A CPU tensor on `device`, in its shape: through device_put_chunked
    (128 lanes, the tail padded with zeros and cut off again) when it is
    above `stage_threshold_bytes()`, in one copy below it, as
    maybe_chunked_stage decides for the benchmark's payload."""
    if device.type != "cpu":
        flat = x.reshape(-1)
        staged = maybe_chunked_stage(flat, -(-flat.numel() // 128), 128,
                                     0, device)
        if staged is not None:
            return staged.reshape(-1)[:flat.numel()].view(x.shape)
    return x.to(device)


def check_chunk_bytes(chunk2d: torch.Tensor,
                      chunk_bytes: Optional[int] = None) -> None:
    """Refuse a chunk above the per-chunk bound (plus eight rows)."""
    bound = stage_chunk_bytes(chunk_bytes)
    itemsize = chunk2d.element_size()
    allowance = chunk2d.shape[-1] * itemsize if chunk2d.dim() else 0
    nbytes = chunk2d.numel() * itemsize
    if nbytes > bound + 8 * allowance:
        raise ValueError(f"streaming chunk of {nbytes} B exceeds the "
                         f"{bound} B per-chunk bound "
                         "(config.stage_chunk_bytes)")


class ChunkStager:
    """`slots` chunk buffers of `rows` x `lanes` elements per plane, one
    plane per entry of `dtypes`, on `device`."""

    def __init__(self, device: torch.device, rows: int,
                 dtypes: Sequence[torch.dtype], *, slots: int = 2,
                 chunk_bytes: Optional[int] = None,
                 lanes: int = 128) -> None:
        self.device = device
        self.chunk_bytes = chunk_bytes
        self._cuda = device.type == "cuda"
        if not self._cuda:
            return
        shape = (rows, lanes)
        self._pinned = [[torch.empty(shape, dtype=dt, pin_memory=True)
                         for dt in dtypes] for _ in range(slots)]
        self._dev = [[torch.empty(shape, dtype=dt, device=device)
                      for dt in dtypes] for _ in range(slots)]
        self._side = torch.cuda.Stream(device)
        self._ready = [None] * slots     # copy into the slot done
        self._freed = [None] * slots     # fold that read the slot done

    def put_chunk_async(self, slot: int, planes: Sequence[torch.Tensor]
                        ) -> tuple:
        """Start the copy of one chunk (its padded planes, CPU tensors of
        at most `rows` rows) into `slot`; returns the device planes, which
        acquire(slot) makes safe to read."""
        for plane in planes:
            check_chunk_bytes(plane, self.chunk_bytes)
        if not self._cuda:
            return tuple(p.clone() for p in planes)
        if self._ready[slot] is not None:
            self._ready[slot].synchronize()     # the pinned buffer is free
        k = planes[0].shape[0]
        for pinned, plane in zip(self._pinned[slot], planes):
            pinned[:k].copy_(plane)
        with torch.cuda.stream(self._side):
            if self._freed[slot] is not None:
                self._side.wait_event(self._freed[slot])
            for dev, pinned in zip(self._dev[slot], self._pinned[slot]):
                dev[:k].copy_(pinned[:k], non_blocking=True)
            self._ready[slot] = torch.cuda.Event()
            self._ready[slot].record(self._side)
        return tuple(dev[:k] for dev in self._dev[slot])

    def acquire(self, slot: int) -> None:
        """Make the current stream wait until the slot's copy is done."""
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._ready[slot])

    def release(self, slot: int) -> None:
        """Mark the slot free once the current stream's queued reads of
        it are done."""
        if self._cuda:
            self._freed[slot] = torch.cuda.Event()
            self._freed[slot].record(torch.cuda.current_stream(self.device))
