"""The idle share of the slice on each card, in percent, averaged over
the cards; each card's own share is printed on a line of its own."""


def _idle(card):
    return 100.0 * (1.0 - card.busy_s() / card.length_s)


def read(s):
    cards = [c for c in s.cards if c.length_s > 0 and c.device]
    if len(cards) != len(s.cards):
        return None
    return sum(_idle(c) for c in cards) / len(cards)


def lines(s):
    return [f"device_idle_pct.mpi card {i}: {_idle(c)!r}"
            for i, c in enumerate(s.cards) if c.length_s > 0 and c.device]
