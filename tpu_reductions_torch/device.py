"""Device resolution: the card unless the caller asks for the CPU.

With no CUDA device and no explicit CPU request, `resolve` raises; the
port never drops quietly to the CPU.

A process of a multi-process run on the card drives a card of its own,
`cuda:<local rank>` (`local_rank`: LOCAL_RANK when set, else the process
id), the MPI model of one process per rank group: `resolve` names it and
refuses a host whose processes outnumber its cards, and `own_card`, which
the join calls once the watchdog is armed (parallel/mesh.py), also sets
it as the process's current device.

One process can also spread work over the host's cards: `cards` lists
them (a query, no context), and `rank_blocks` places K ranks on them in
contiguous, rank-ordered blocks (the serving shard route,
serve/executor.py).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from tpu_reductions_torch.config import PLATFORMS


def resolve(platform: str = "gpu", index: Optional[int] = None, *,
            process_id: Optional[int] = None,
            num_processes: Optional[int] = None) -> torch.device:
    """`cuda` / `cuda:<index>` for platform gpu, `cpu` on request. With
    `num_processes` > 1 on the card, this process's own card
    (`card_of`)."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "gpu":
        raise ValueError(f"platform must be one of {PLATFORMS}, "
                         f"got {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "--platform=cpu (or device='cpu') to run on "
                           "the CPU")
    if (num_processes or 1) > 1:
        return card_of(process_id, num_processes)
    return torch.device("cuda" if index is None else f"cuda:{index}")


def local_rank(process_id: Optional[int]) -> int:
    """This process's index among the processes of its host: LOCAL_RANK
    when the launcher set it, else the process id (every process on one
    host)."""
    env = os.environ.get("LOCAL_RANK", "")
    return int(env) if env.strip() else int(process_id or 0)


def card_of(process_id: Optional[int], num_processes: int
            ) -> torch.device:
    """`cuda:<local rank>` for a process of a `num_processes`-process
    run, every process on this host; raises when they outnumber its
    cards, or the local rank names no card. Never the CPU."""
    cards = torch.cuda.device_count()
    if num_processes > cards:
        raise RuntimeError(
            f"{num_processes} processes on this host but {cards} card(s): "
            f"each process of a multi-process run drives a card of its own "
            f"(two processes on one card is NCCL's duplicate GPU "
            f"failure); run at most {cards} process(es) here and put more "
            f"ranks in each as rows (--devices), or pass --platform=cpu")
    local = local_rank(process_id)
    if not 0 <= local < cards:
        raise RuntimeError(
            f"local rank {local} names no card: this host has {cards} "
            f"(cuda:0..cuda:{cards - 1})")
    return torch.device("cuda", local)


def own_card(process_id: Optional[int], num_processes: int
             ) -> torch.device:
    """`card_of`, set as this process's current device (NCCL's
    collectives and the bare `cuda` device then land on it)."""
    card = card_of(process_id, num_processes)
    torch.cuda.set_device(card)
    return card


def cards(platform: str) -> List[torch.device]:
    """The host's cards in index order, `cuda:0` up to
    `cuda:<device_count - 1>` (CUDA_VISIBLE_DEVICES restricts them), or
    `[cpu]` for platform cpu. A query: it creates no CUDA context."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform != "gpu":
        raise ValueError(f"platform must be one of {PLATFORMS}, "
                         f"got {platform!r}")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def rank_blocks(ranks: int, num_cards: int) -> List[range]:
    """K ranks on C' = min(C, K) cards in contiguous, rank-ordered
    blocks: card c holds ranks [c*K//C', (c+1)*K//C')."""
    if ranks < 1 or num_cards < 1:
        raise ValueError(f"ranks and cards must be >= 1, got {ranks} "
                         f"ranks on {num_cards} card(s)")
    used = min(ranks, num_cards)
    return [range(c * ranks // used, (c + 1) * ranks // used)
            for c in range(used)]


def count(platform: str) -> int:
    """Number of devices of the platform (the CPU counts as one)."""
    if platform == "cpu":
        return 1
    return torch.cuda.device_count()


def name(device: torch.device) -> str:
    """`torch.cuda.get_device_name()` of a card, `cpu` for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU, which runs
    eagerly)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
