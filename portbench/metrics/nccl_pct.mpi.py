"""The share of card 0's busy time in the slice's collectives (the device
work that began inside a `collective` span) spent in kernels whose names
begin with `nccl`, in percent."""


def read(s):
    card = s.cards[0].during("collective")
    busy = card.busy_s()
    if busy <= 0:
        return None
    return 100.0 * card.busy_s(lambda name: name.startswith("nccl")) / busy
