"""Double-buffered host-to-device chunk staging for the streaming pipeline.

The counterpart of `put_chunk_async` in tpu_reductions/utils/staging.py.
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

from tpu_reductions_torch.config import stage_chunk_bytes


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
    """`slots` chunk buffers of `rows` x 128 elements per plane, one plane
    per entry of `dtypes`, on `device`."""

    def __init__(self, device: torch.device, rows: int,
                 dtypes: Sequence[torch.dtype], *, slots: int = 2,
                 chunk_bytes: Optional[int] = None) -> None:
        self.device = device
        self.chunk_bytes = chunk_bytes
        self._cuda = device.type == "cuda"
        if not self._cuda:
            return
        shape = (rows, 128)
        self._pinned = [[torch.empty(shape, dtype=dt, pin_memory=True)
                         for dt in dtypes] for _ in range(slots)]
        self._dev = [[torch.empty(shape, dtype=dt, device=device)
                      for dt in dtypes] for _ in range(slots)]
        self._side = torch.cuda.Stream(device)
        self._ready = [None] * slots     # copy into the slot done
        self._freed = [None] * slots     # fold that read the slot done

    def put_chunk_async(self, slot: int, planes: Sequence[torch.Tensor]
                        ) -> tuple:
        """Start the copy of one chunk (its padded planes, CPU tensors)
        into `slot`; returns the device planes, which acquire(slot) makes
        safe to read."""
        for plane in planes:
            check_chunk_bytes(plane, self.chunk_bytes)
        if not self._cuda:
            return tuple(p.clone() for p in planes)
        if self._ready[slot] is not None:
            self._ready[slot].synchronize()     # the pinned buffer is free
        for pinned, plane in zip(self._pinned[slot], planes):
            pinned.copy_(plane)
        with torch.cuda.stream(self._side):
            if self._freed[slot] is not None:
                self._side.wait_event(self._freed[slot])
            for dev, pinned in zip(self._dev[slot], self._pinned[slot]):
                dev.copy_(pinned, non_blocking=True)
            self._ready[slot] = torch.cuda.Event()
            self._ready[slot].record(self._side)
        return tuple(self._dev[slot])

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
