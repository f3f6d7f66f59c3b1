"""The card's idle share of the slice: 1 - the union of its device
intervals over the slice's length, in percent."""


def read(s):
    card = s.cards[0]
    if card.length_s <= 0 or not card.device:
        return None
    return 100.0 * (1.0 - card.busy_s() / card.length_s)
