"""Card 0's busy time in the slice's collectives (the device work that
began inside a `collective` span) outside NCCL kernels, over the slice's
collectives, in milliseconds: the rank-axis combine, the butterfly's
gathers and combines, the all-gather's cat and index_select and the
replicate's copies."""


def read(s):
    card = s.cards[0].during("collective")
    if s.ops == 0 or not card.device:
        return None
    nccl = card.busy_s(lambda name: name.startswith("nccl"))
    return (card.busy_s() - nccl) / s.ops * 1e3
