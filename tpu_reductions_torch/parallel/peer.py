"""The peer group: the cards of one process, one host thread a card.

No reference analog as a module. The JAX package's drain runs its
program on a mesh over the host's first k chips in one process
(`make_mesh`, tpu_reductions/reshard/primitives.py:144-150). The port's
counterpart (serve/executor.BatchExecutor.run_reshard) places the k ranks
on C' = min(k, C) cards in rank-ordered blocks and runs the program in C'
host threads, one a card. Each thread sees a rank mesh of its own
(parallel/mesh.peer_meshes) in which its card is a "process"; this group
stands where the process group stands, and offers what the mesh's
collectives take from torch.distributed (parallel/mesh.comm): an
all-reduce (SUM/MIN/MAX), an all-gather of equal pieces, a batch of
point-to-point row copies, a broadcast and a barrier.

Each call is a host rendezvous (`threading.Barrier`) around `Tensor.copy_`
between cards:

  post     every thread puts what it offers in its slot, then waits for
           the others (the first barrier);
  pull     every thread copies what it needs from the other slots into
           fresh buffers on its own card, a peer copy over NVLink where
           the cards have peer access (else CUDA stages it through host
           memory);
  release  every thread waits for the others again (the second barrier),
           so that no thread writes or frees what it offered before every
           pull of it is enqueued.

Stream order: every thread runs its card's work on the card's default
stream (serve/executor.BatchExecutor._on_card), and a copy between two
cards is ordered by torch against the current streams of both: it waits
for what was enqueued on either card before it and the destination's
later work waits for it. The barriers order the host, so each copy is
enqueued after its source was written and before it is overwritten. On
the CPU the pulls are real copies too: a buffer is never handed over.

The all-reduce combines the cards' values in card order, so that every
card computes the same bits whichever thread arrives first.

A failure: the thread that raised aborts the group (`abort`), and every
thread waiting or arriving at a rendezvous raises PeerAborted; a
rendezvous that waits DIST_TIMEOUT_S (the process group's timeout) does
too. A card outside the mesh has no thread and enters no rendezvous.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from tpu_reductions_torch.parallel.mesh import DIST_TIMEOUT_S


class PeerAborted(RuntimeError):
    """A rendezvous of the peer group broke: another card's thread failed
    (and aborted the group) or the wait timed out."""


def _fresh(src: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of `src` in a new buffer on `device` (never `src` itself,
    even on the same device)."""
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    out.copy_(src)
    return out


class PeerGroup:
    """The rendezvous of C' card threads (module docstring). Made once per
    program run by run_reshard; `member(c)` is card c's handle."""

    def __init__(self, size: int, timeout_s: float = DIST_TIMEOUT_S
                 ) -> None:
        if size < 2:
            raise ValueError(f"a peer group needs >= 2 cards, got {size}")
        self.size = int(size)
        self.timeout_s = float(timeout_s)
        self._barrier = threading.Barrier(self.size, timeout=timeout_s)
        self._slots: List[object] = [None] * self.size

    def member(self, card: int) -> "PeerMember":
        """Card `card`'s handle: the collectives as its thread calls them."""
        return PeerMember(self, card)

    def abort(self) -> None:
        """Break every rendezvous, now and later: each thread of the
        group raises PeerAborted at its next one."""
        self._barrier.abort()

    def wait(self) -> None:
        """One rendezvous of every card's thread."""
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError as e:
            raise PeerAborted(
                f"a rendezvous of the {self.size}-card peer group broke: "
                f"another card's thread failed, or one did not come "
                f"within {self.timeout_s:g} s") from e

    def post(self, card: int, value) -> list:
        """Card `card` offers `value`; returns every card's offer, in card
        order, once all have offered (the first barrier)."""
        self._slots[card] = value
        self.wait()
        return list(self._slots)

    def release(self) -> None:
        """The second barrier: every pull of this round is enqueued."""
        self.wait()


class PeerMember:
    """Card `card`'s side of its PeerGroup: the calls of parallel/mesh.comm,
    each a post, the pulls onto this card, and a release."""

    def __init__(self, group: PeerGroup, card: int) -> None:
        self.group = group
        self.card = card

    def all_reduce(self, t: torch.Tensor, method: str) -> None:
        """`t` combined elementwise over the cards, in card order, in
        place (torch.distributed.all_reduce's contract)."""
        from tpu_reductions_torch.ops.registry import get_op
        combine = get_op(method).combine
        offers = self.group.post(self.card, t)
        acc = None
        for c, other in enumerate(offers):
            part = other if c == self.card else _fresh(other, t.device)
            acc = part if acc is None else combine(acc, part)
        self.group.release()
        t.copy_(acc)

    def all_gather(self, got: Sequence[torch.Tensor],
                   mine: torch.Tensor) -> None:
        """got[c] <- card c's `mine`, every piece of one shape."""
        offers = self.group.post(self.card, mine)
        for out, other in zip(got, offers):
            out.copy_(other)
        self.group.release()

    def exchange(self, wire: Sequence[tuple]) -> None:
        """One hop's row copies: `wire` lists (is_send, tensor, peer card,
        tag); a receive pulls the tensor that `peer` sent to this card
        under `tag` into its own (fresh) tensor."""
        sends = {(peer, tag): t for send, t, peer, tag in wire if send}
        offers = self.group.post(self.card, sends)
        for send, t, peer, tag in wire:
            if not send:
                t.copy_(offers[peer][(self.card, tag)])
        self.group.release()

    def broadcast(self, t: torch.Tensor, src: int) -> None:
        """t <- card `src`'s t."""
        offers = self.group.post(self.card,
                                 t if self.card == src else None)
        if self.card != src:
            t.copy_(offers[src])
        self.group.release()

    def barrier(self) -> None:
        self.group.wait()


def first_failure(errors: Sequence[Optional[BaseException]]
                  ) -> Optional[BaseException]:
    """The error that broke a run of the card threads: the first that is
    not another thread's PeerAborted (a card's own fault), else the first.
    No reference analog."""
    real = [e for e in errors if e is not None
            and not isinstance(e, PeerAborted)]
    if real:
        return real[0]
    return next((e for e in errors if e is not None), None)
