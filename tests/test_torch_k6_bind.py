"""k6's bound launch (ops/kernel_reduce.K6Binding, StagedK6), its
counter (obs/spans.K6_BOUND) and the benchmark's reader of it
(portbench/metrics/program_bound_pct.py), on the CPU.

A fake card (ops/_cuda.Card) stands in for the runtime: its tensors live
on the `meta` device (shapes and dtypes, no data), its launcher and its
stream lookup record what they are given. The card's own tests are in
tests/test_torch_cuda.py.
"""

import contextlib
import sys
import threading

import pytest
import torch

from portbench import harness
from tpu_reductions_torch.obs import spans
from tpu_reductions_torch.ops import _cuda
from tpu_reductions_torch.ops import kernel_reduce as kr
from tpu_reductions_torch.ops.registry import get_op

SMS, CLUSTERS = 132, 16
SDK_NS = (1 << 24, (1 << 20) + 7, 1 << 29)


class FakeCard:
    """A Card on the meta device: `streams` maps a host thread to its
    current stream (0 unless set), `current` is the current device's
    index, `capture` whether the stream captures. It stands in for
    _cuda.k6_args and _cuda.k6_reduce too: every set of launch arguments
    made and every launch are kept."""

    def __init__(self):
        self.streams = {}
        self.current = None
        self.capture = False
        self.launchers = []
        self.launches = []
        self.guarded = []
        self.card = _cuda.Card("meta", self.stream, lambda: self.capture,
                               lambda: self.current, self.guard)

    def stream(self, index):
        return self.streams.get(threading.get_ident(), 0)

    @contextlib.contextmanager
    def guard(self, index):
        self.guarded.append(index)
        yield

    def launcher(self, rows, plan, op_name, dtype):
        made = (rows, plan, op_name, dtype)
        self.launchers.append(made)
        return made

    def launch(self, x, partials, out, args, stream):
        self.launches.append((args, x, partials, out, stream))


@pytest.fixture
def fake(monkeypatch):
    card = FakeCard()
    monkeypatch.setattr(_cuda, "card", lambda: card.card)
    monkeypatch.setattr(_cuda, "k6_args", card.launcher)
    monkeypatch.setattr(_cuda, "k6_reduce", card.launch)
    monkeypatch.setattr(kr, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(kr, "_active_clusters",
                        lambda device, op_name, dtype: CLUSTERS)
    spans.K6_BOUND.reset()
    yield card
    spans.K6_BOUND.reset()


def staged(n, dtype, device="meta"):
    """The staged (rows, 128) tensor of n elements at the SDK's tiling
    (256 threads, 64 blocks), on `device` (no data on meta)."""
    rows, lanes = kr.padded_2d_shape(n, *kr.choose_tiling(n, 256, 64, dtype))
    return torch.empty((rows, lanes), dtype=getattr(torch, dtype),
                       device=device)


def counts():
    c = spans.K6_BOUND
    return c.hits, c.binds, c.misses


# --- the binding -----------------------------------------------------------

@pytest.mark.parametrize("n", SDK_NS)
@pytest.mark.parametrize("dtype", ["int32", "float64"])
def test_the_bound_plan_is_plan_k6_of_the_staged_shape(fake, dtype, n):
    x2d = staged(n, dtype)
    k6 = kr.StagedK6(get_op("SUM"))
    out = k6.call(x2d)
    sub = kr.sublanes_for(dtype)
    want = kr.plan_k6(x2d.shape[0], sub, SMS, CLUSTERS)
    b = k6.binding
    assert b.plan == want
    assert b.key == (x2d.shape, x2d.dtype, x2d.device)
    assert fake.launchers == [(x2d.shape[0], want, "SUM", x2d.dtype)]
    assert out.shape == (sub, kr.LANES) and out.dtype == x2d.dtype
    (_, x, partials, acc, stream), = fake.launches
    assert x == x2d.data_ptr() and stream == 0
    # the same plan single_pass_call makes for itself, call by call
    kr.single_pass_call(x2d, get_op("SUM"))
    assert fake.launchers[1] == fake.launchers[0]


def test_a_second_call_binds_nothing_and_reuses_the_scratch(fake):
    x2d = staged(1 << 20, "int32")
    k6 = kr.StagedK6(get_op("MAX"))
    first = k6.call(x2d)
    binding = k6.binding
    outs = [k6.call(x2d) for _ in range(5)]
    assert k6.binding is binding and len(fake.launchers) == 1
    assert all(o is first for o in outs)
    assert len(binding.kept) == 1 and len(fake.launches) == 6
    assert counts() == (5, 1, 0)
    # single_pass_call binds anew and allocates anew on every call
    a, b = (kr.single_pass_call(x2d, get_op("MAX")) for _ in range(2))
    assert a is not b and a is not first
    assert len(fake.launchers) == 3 and counts() == (5, 1, 0)


def test_more_than_one_partial_block_gets_its_own_partials(fake):
    k6 = kr.StagedK6(get_op("SUM"))
    k6.call(staged(1 << 24, "float64"))
    b = k6.binding
    assert b.plan.blocks > 1
    (out, partials, _, _), = b.kept.values()
    assert partials.shape == (b.plan.blocks * 8, kr.LANES)
    small = kr.StagedK6(get_op("SUM"))
    small.call(staged(4096, "float64"))
    assert small.binding.plan.blocks == 1
    (out, partials, _, _), = small.binding.kept.values()
    assert partials is out


def _refusals():
    """Staged tensors the kernels refuse, by what is wrong."""
    rows = staged(1 << 20, "int32").shape[0]
    skewed = torch.empty(rows * 128 + 1, dtype=torch.int32,
                         device="meta")[1:].view(rows, 128)
    return {
        "shape": torch.empty((rows - 3, 128), dtype=torch.int32,
                             device="meta"),
        "lanes": torch.empty((rows, 64), dtype=torch.int32, device="meta"),
        "dtype": torch.empty((rows, 128), dtype=torch.int64, device="meta"),
        "strides": torch.empty((128, rows), dtype=torch.int32,
                               device="meta").t(),
        "aligned": skewed,
    }


@pytest.mark.parametrize("wrong", ["shape", "lanes", "dtype", "strides",
                                   "aligned"])
@pytest.mark.parametrize("bound_first", [False, True])
def test_a_tensor_the_kernels_refuse_raises_as_single_pass_call_does(
        fake, wrong, bound_first):
    bad = _refusals()[wrong]
    op = get_op("SUM")
    with pytest.raises(ValueError) as today:
        kr.single_pass_call(bad, op)
    k6 = kr.StagedK6(op)
    if bound_first:
        k6.call(staged(1 << 20, "int32"))
    with pytest.raises(ValueError) as bound:
        k6.call(bad)
    assert str(bound.value) == str(today.value)
    assert (k6.binding is not None) == bound_first
    # the refused tensor never reached the launcher
    assert len(fake.launches) == int(bound_first)


def test_a_tensor_off_the_card_raises_as_single_pass_call_does():
    """With the runtime's own card a meta tensor is on no CUDA device."""
    x2d = staged(1 << 20, "int32")
    op = get_op("MIN")
    with pytest.raises(ValueError, match="run on CUDA tensors") as today:
        kr.single_pass_call(x2d, op)
    stage_fn, reduce_fn = kr.make_staged_reduce("MIN", 1 << 20, "int32")
    with pytest.raises(ValueError) as bound:
        reduce_fn(x2d)
    assert str(bound.value) == str(today.value)


def test_a_host_tensor_takes_the_plain_version_bound_or_not(fake):
    k6 = kr.StagedK6(get_op("SUM"))
    x = torch.arange(1 << 14, dtype=torch.int32).view(-1, 128)
    want = kr.single_pass_plain(x, get_op("SUM"))
    assert torch.equal(k6.call(x), want)
    assert k6.binding is None
    k6.call(staged(1 << 14, "int32"))
    assert torch.equal(k6.call(x), want)
    assert counts() == (0, 1, 0) and len(fake.launches) == 1


def test_another_shape_takes_the_unbound_path_with_fresh_scratch(fake):
    k6 = kr.StagedK6(get_op("SUM"))
    bound = k6.call(staged(1 << 20, "int32"))
    other = staged(1 << 21, "int32")
    a, b = k6.call(other), k6.call(other)
    assert a is not b and a is not bound
    assert len(k6.binding.kept) == 1
    assert k6.binding.key[0] == staged(1 << 20, "int32").shape
    assert counts() == (0, 1, 2)
    assert [m[0] for m in fake.launchers] == [
        staged(1 << 20, "int32").shape[0]] + [other.shape[0]] * 2


def test_a_capturing_stream_allocates_fresh(fake):
    x2d = staged(1 << 20, "float64")
    k6 = kr.StagedK6(get_op("SUM"))
    fake.capture = True
    first = k6.call(x2d)
    captured = k6.call(x2d)
    assert k6.binding is not None and k6.binding.kept == {}
    assert captured is not first
    fake.capture = False
    kept = k6.call(x2d)
    assert k6.call(x2d) is kept and kept is not captured
    assert counts() == (2, 1, 1)


def test_the_device_guard_is_entered_only_off_the_current_device(fake):
    x2d = staged(1 << 20, "int32")
    k6 = kr.StagedK6(get_op("SUM"))
    k6.call(x2d)
    assert fake.guarded == []
    fake.current = 3
    k6.call(x2d)
    kr.single_pass_call(x2d, get_op("SUM"))
    assert fake.guarded == [None, None]
    assert len(fake.launches) == 3


def test_two_streams_get_distinct_scratch(fake):
    x2d = staged(1 << 20, "int32")
    k6 = kr.StagedK6(get_op("SUM"))
    me = threading.get_ident()
    on = {}
    for stream in (11, 22, 11, 22):
        fake.streams[me] = stream
        on.setdefault(stream, []).append(k6.call(x2d))
    assert on[11][0] is on[11][1] and on[22][0] is on[22][1]
    assert on[11][0] is not on[22][0]
    assert set(k6.binding.kept) == {(11, me), (22, me)}
    pairs = list(k6.binding.kept.values())
    assert pairs[0][1] is not pairs[1][1]
    assert [launch[-1] for launch in fake.launches] == [11, 22, 11, 22]


def test_two_threads_get_distinct_scratch(fake):
    x2d = staged(1 << 24, "float64")
    k6 = kr.StagedK6(get_op("SUM"))
    k6.call(x2d)
    got = {}
    both, done = threading.Barrier(2), threading.Barrier(2)

    def run(name):
        both.wait(30)        # both alive at once: two thread idents
        got[name] = [k6.call(x2d) for _ in range(3)]
        done.wait(30)        # and alive while the other makes its pair

    threads = [threading.Thread(target=run, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    a, b = got["a"], got["b"]
    assert all(o is a[0] for o in a) and all(o is b[0] for o in b)
    assert a[0] is not b[0]
    assert len(k6.binding.kept) == 3
    partials = [p for _, p, _, _ in k6.binding.kept.values()]
    assert len({id(p) for p in partials}) == 3
    assert counts() == (6, 1, 0)


def test_threads_hammering_one_binding_each_keep_their_own_pair(fake):
    """More threads than cores, a short switch interval: every thread's
    calls come back to its own pair, on its own stream, and no two
    threads ever share one."""
    x2d = staged(1 << 20, "int32")
    k6 = kr.StagedK6(get_op("SUM"))
    k6.call(x2d)
    workers, calls = 24, 200
    got, errors = {}, []
    start, done = threading.Barrier(workers), threading.Barrier(workers)

    def run(w):
        try:
            fake.streams[threading.get_ident()] = 1000 + w % 3
            start.wait(30)
            got[w] = {id(k6.call(x2d)) for _ in range(calls)}
            done.wait(30)
        except Exception as e:       # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(w,))
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(len(ids) == 1 for ids in got.values())
    assert len({ids.pop() for ids in got.values()}) == workers
    assert len(k6.binding.kept) == workers + 1
    assert len(fake.launches) == workers * calls + 1


def test_a_new_pair_drops_the_pairs_of_ended_threads(fake):
    x2d = staged(1 << 20, "int32")
    k6 = kr.StagedK6(get_op("SUM"))
    k6.call(x2d)
    kept = []

    def run():
        kept.append(k6.call(x2d))

    for _ in range(3):
        t = threading.Thread(target=run)
        t.start()
        t.join(30)
    mine = k6.call(x2d)
    me = threading.get_ident()
    # an ended thread's pair goes when the next pair is made (a thread
    # given an ended one's ident takes its pair over)
    assert len(k6.binding.kept) == 2
    assert (0, me) in k6.binding.kept
    # a new stream of a live thread makes a pair, and drops the last
    # ended thread's
    fake.streams[me] = 7
    k6.call(x2d)
    assert set(k6.binding.kept) == {(0, me), (7, me)}
    assert k6.call(x2d) is not mine
    fake.streams[me] = 0
    assert k6.call(x2d) is mine
    assert counts() == (7, 1, 0)


# --- the counter and its reader --------------------------------------------

def _reader():
    return harness.load_module(harness.BENCH_DIR, "metrics",
                               "program_bound_pct")


def test_the_counter_adds_up_through_reduce_fn(fake):
    n = 1 << 20
    stage_fns = {}
    fns = []
    for method, dtype in (("MAX", "int32"), ("SUM", "int32"),
                          ("SUM", "float64")):
        stage_fn, reduce_fn = kr.make_staged_reduce(method, n, dtype)
        stage_fns[dtype] = stage_fn
        fns.append((reduce_fn, staged(n, dtype)))
    assert _reader().read(None) is None
    for _ in range(4):
        for reduce_fn, x2d in fns:
            reduce_fn(x2d)
    reduce_fn, x2d = fns[0]
    reduce_fn(staged(2 * n, "int32"))          # another shape: a miss
    reduce_fn(torch.zeros((8, 128), dtype=torch.int32))   # host: no count
    assert counts() == (9, 3, 1)
    assert spans.K6_BOUND.calls() == 13
    assert len(fake.launches) == 13
    assert _reader().read(None) == pytest.approx(100 * 9 / 13)


def test_the_counter_is_on_without_the_recorder_and_with_it(fake):
    stage_fn, reduce_fn = kr.make_staged_reduce("SUM", 1 << 20, "int32")
    x2d = staged(1 << 20, "int32")
    reduce_fn(x2d)
    spans.reset_hot()
    spans.arm_hot()
    try:
        reduce_fn(x2d)
        reduce_fn(x2d)
    finally:
        spans.reset_hot()
    assert counts() == (2, 1, 0)


def test_the_bound_path_stamps_every_section(fake):
    stage_fn, reduce_fn = kr.make_staged_reduce("MIN", 1 << 20, "float64")
    x2d = staged(1 << 20, "float64")
    spans.reset_hot()
    spans.arm_hot()
    try:
        for _ in range(3):
            reduce_fn(x2d)
        recs = spans.hot_records(False)
    finally:
        spans.reset_hot()
    assert len(recs) == 3
    for rec in recs:
        # the fake's device is not "cuda": reduce_fn opens no profiler
        # range, but k6 stamps its plan, scratch and launch all the same
        assert set(spans.hot_sections(rec)) == set(spans.HOT_SPANS)
        assert (rec[spans.START] <= rec[spans.PLAN_END]
                <= rec[spans.ALLOC_END] <= rec[spans.LAUNCH_END]
                <= rec[spans.FINISH_START] <= rec[spans.END])


def test_the_reader_gives_none_without_the_counter(monkeypatch):
    monkeypatch.delattr(spans, "K6_BOUND")
    assert _reader().read(None) is None


def test_the_reader_is_listed_for_both_sdk_cells():
    spec = harness.load_spec()
    for cell in ("sdk_reduction.awaited-2e24", "sdk_reduction.awaited-2gib"):
        names = {m["name"] for m in harness.resolve(spec, cell).per_layer}
        assert "program_bound_pct" in names
