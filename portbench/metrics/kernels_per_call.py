"""Device kernels, copies and memsets of the slice's calls (all but those
that began while the benchmark fetched answers, its `collect` span), over
its calls."""


def read(s):
    work = s.cards[0].outside("collect").device
    if s.ops == 0 or not work:
        return None
    return len(work) / s.ops
