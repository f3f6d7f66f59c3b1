"""The share of k6's reduce calls on the card, over the whole process,
that took their reduce_fn's bound launch, in percent: the program's
counter (tpu_reductions_torch/obs/spans.py, K6_BOUND), its hits over its
hits, binds and misses. Nothing where the program has no such counter
or ran no k6 call on the card."""


def read(s):
    from tpu_reductions_torch.obs import spans
    count = getattr(spans, "K6_BOUND", None)
    if count is None or not count.calls():
        return None
    return 100.0 * count.hits / count.calls()
