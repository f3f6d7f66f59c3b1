"""Data-dependent chained reduction, for slope timing.

The counterpart of tpu_reductions/ops/chain.py:1: `chained(x2d, k)` runs k
reductions, each folding its scalar into element [0, 0] of the next one's
input with the op's own combine, so no iteration can be skipped or
hoisted; the caller materializes the last scalar once, which bounds the
completion of all k.

The JAX chain runs its k iterations inside one compiled program, so the
slope (t(k_hi) - t(k_lo)) / (k_hi - k_lo) holds the device's time of an
iteration and nothing of the host's. The port's counterpart of that
program is a CUDA graph: on a CUDA tensor the k iterations (core, then
fold) are captured once per (k, staged shape) and replayed for every
timed trip, so an iteration costs its kernels and no Python. The capture
falls inside time_chained's discarded warm-up trips, as the JAX compile
does. A core that cannot be captured raises: the eager loop is never
timed on the card. It runs there only as `eager`, the check a timed
chain's scalar is held against (bench/collective_driver.py). With one
process a card (collectives/core.py over NCCL)
each process captures its own graph of the k collectives after the
warm-up collective has made every communicator, and the processes then
replay in step, each trip's collectives meeting across the cards. On a CPU
tensor the chain is that eager loop, the plain path the tests run.

`core` is `core(x2d) -> scalar`, or, on the f64 pair route, `core(hi2d,
lo2d) -> (s_hi, s_lo)` with `x2d` the tuple of the two planes: then the
first plane's scalar is folded into the first plane's [0, 0] and returned.

JAX's loop carry is a fresh array; here the fold is an in-place write.
So the chain runs on copies of the staged tensors (a clone on the CPU,
the graph's own input buffers on the card, refilled every call; either
copy is a constant cost that cancels in the slope), and the caller's
tensors, which the driver verifies afterwards, stay as they were staged.

The kernel wrappers count their launches as Python runs them. A capture
runs them without launching anything, so the chain takes back what the
capture counted and adds it again at every replay: the counters read the
captured launches times the replays.

`auto_chain_span` sizes the chain's span (the iterations between the
slope's two ends) for a chained shmoo cell.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Union

import torch

from tpu_reductions_torch.ops import dd_reduce, kernel_reduce
from tpu_reductions_torch.ops.registry import ReduceOpSpec, torch_dtype

Staged = Union[torch.Tensor, tuple]

# The rates a span is sized from: the card's device-memory rate (H100 SXM
# data sheet, 700 W), and the JAX package's host rate, so that the spans
# on the CPU equal its spans there. A span covers about SPAN_SIGNAL_S of
# work, within [SPAN_MIN, SPAN_MAX] iterations (the JAX package's values).
CARD_BYTES_PER_S = 3.35e12
CPU_BYTES_PER_S = 10e9
SPAN_SIGNAL_S = 6e-3
SPAN_MIN, SPAN_MAX = 8, 4096


def auto_chain_span(n: int, dtype: str, platform: str = "gpu") -> int:
    """The span for chained timing at payload size n: enough iterations
    for about SPAN_SIGNAL_S of work at the platform's rate (the card's
    memory rate, or the host's). A fixed span is noise-bound at small n
    and wastes minutes at large n.
    The counterpart of tpu_reductions/ops/chain.py:71."""
    rate = CPU_BYTES_PER_S if platform == "cpu" else CARD_BYTES_PER_S
    est_iter_s = n * torch_dtype(dtype).itemsize / rate
    return max(SPAN_MIN, min(SPAN_MAX, math.ceil(
        SPAN_SIGNAL_S / max(est_iter_s, 1e-9))))


def counted_wrappers() -> tuple:
    """The kernel wrappers whose `launches` a chain keeps true: k6, k7,
    k8, k9, k10 and the pair kernel dd.
    No reference analog: the launch counters are the port's."""
    return (kernel_reduce.single_pass_call, kernel_reduce.two_pass_call,
            kernel_reduce.elementwise_call, kernel_reduce.mxu_call,
            kernel_reduce.stream_call, dd_reduce.dd_call)


def fold_into(first: torch.Tensor, last: torch.Tensor,
              op: ReduceOpSpec) -> None:
    """The chain's fold: combine the iteration's scalar into first[0, 0],
    in place (one elementwise launch on the card).
    The fold of tpu_reductions/ops/chain.py:147."""
    head = first[0, 0]
    op.combine(head, last.to(first.dtype), out=head)


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per device that every capture runs on, so the
    per-stream tickets of k8 and dd (kernel_reduce._tickets) are
    allocated and zeroed once, by a warm-up step outside any capture."""
    return torch.cuda.Stream(device)


def _capture_mode() -> str:
    """CUDA's stream-capture mode for a chain's graph: "global" (torch's
    default) in one process; "thread_local" when a process group runs, so
    that its communication library's own threads may still query their
    events while this thread captures the collectives."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return "thread_local"
    return "global"


def _refill(buffers: tuple, planes: tuple) -> None:
    for buf, p in zip(buffers, planes):
        buf.copy_(p)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor          # the last iteration's scalar, in the graph
    launches: tuple            # per counted wrapper, captured launches


class ChainedReduce:
    """`chained(x2d, k) -> 0-d tensor`: k data-dependent iterations of
    `core` (k >= 1); see the module docstring. `close()` frees the card's
    graphs and their input buffers (a row's chain is closed when the row
    is timed). `fold=False` leaves the input as it is: a process of a
    collective that does not hold rank 0, whose element the chain folds
    into (collectives/core.make_chained_collective).
    The counterpart of tpu_reductions/ops/chain.py:135."""

    def __init__(self, core: Callable, op: ReduceOpSpec,
                 fold: bool = True) -> None:
        self.core = core
        self.op = op
        self.fold = fold
        self._buffers: dict = {}     # staged shapes -> input buffers
        self._graphs: dict = {}      # (staged shapes, k) -> _Graph

    def _step(self, planes: tuple, pair: bool) -> torch.Tensor:
        last = self.core(*planes)[0] if pair else self.core(planes[0])
        if self.fold:
            fold_into(planes[0], last, self.op)
        return last

    def __call__(self, x2d: Staged, k: int) -> torch.Tensor:
        if k < 1:
            raise ValueError(f"a chain runs k >= 1 iterations, got {k}")
        pair = isinstance(x2d, tuple)
        planes = tuple(x2d) if pair else (x2d,)
        if planes[0].device.type != "cuda":
            return self.eager(x2d, k)
        shapes = tuple((p.shape, p.dtype, p.device) for p in planes)
        buffers = self._buffers.get(shapes)
        if buffers is None:
            buffers = self._buffers[shapes] = tuple(
                torch.empty_like(p) for p in planes)
        entry = self._graphs.get((shapes, k))
        if entry is None:
            _refill(buffers, planes)       # the warm-up step reads real data
            entry = self._graphs[(shapes, k)] = self._capture(buffers, pair,
                                                              k)
        _refill(buffers, planes)
        entry.graph.replay()
        for wrapper, n in zip(counted_wrappers(), entry.launches):
            wrapper.launches += n
        return entry.out.clone()

    def eager(self, x2d: Staged, k: int) -> torch.Tensor:
        """The k iterations one by one, on copies of `x2d`, on whatever
        device it lies: the chain itself on the CPU; on the card the
        untimed check of a captured graph's scalar.
        No reference analog: the JAX chain has no second spelling."""
        pair = isinstance(x2d, tuple)
        planes = tuple(p.clone() for p in (x2d if pair else (x2d,)))
        last = None
        for _ in range(k):
            last = self._step(planes, pair)
        return last

    def _capture(self, buffers: tuple, pair: bool, k: int) -> _Graph:
        """Capture k iterations over `buffers` on the capture stream,
        after one eager step there (its first-use costs: library loads,
        plans, tickets, library handles), which folds into the buffers:
        the caller refills them before every replay."""
        device = buffers[0].device
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self._step(buffers, pair)
        wrappers = counted_wrappers()
        before = [w.launches for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode=_capture_mode()):
            for _ in range(k):
                out = self._step(buffers, pair)
        launches = tuple(w.launches - b for w, b in zip(wrappers, before))
        for w, b in zip(wrappers, before):
            w.launches = b         # the capture launched nothing
        torch.cuda.current_stream(device).wait_stream(stream)
        return _Graph(graph, out, launches)

    def close(self) -> None:
        """Free the graphs and their buffers.
        No reference analog: the JAX chain holds no graphs."""
        self._graphs.clear()
        self._buffers.clear()


def make_chained_reduce(core: Callable, op: ReduceOpSpec) -> ChainedReduce:
    """Wrap `core` into `chained(x2d, k) -> 0-d tensor` running k
    data-dependent iterations (k >= 1).
    The counterpart of tpu_reductions/ops/chain.py:104."""
    return ChainedReduce(core, op)
