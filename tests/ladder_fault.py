"""A ladder call whose worker dies: rank `rank` of the group ends its
process with `code` at once, the others return.

    bench.multicard.run_ladder("ladder_fault:exit_on_rank",
                               {"code": 7, "rank": 1}, 2, platform="cpu")

Run by tests/test_torch_ladder_cards.py, which puts this directory on
the workers' PYTHONPATH.
"""

import os


def exit_on_rank(code: int, rank: int, logger=None) -> dict:
    import torch.distributed as dist
    if dist.get_rank() == rank:
        os._exit(code)
    return {"rank": dist.get_rank()}
