"""The reduce call's in-memory span recorder (obs/spans.py: hot_begin,
the two rings, arming by the torch profiler) and the benchmark's readers
of it (portbench/program_spans.py, portbench/metrics/program_*.py).

The recorder is process-wide: every test starts from `reset_hot()` and
leaves it reset. The card test is marked `gpu` and skips elsewhere:

    python -m pytest -q -m gpu --noconftest tests/test_torch_hot_spans.py
"""

import json
import math
import statistics
import sys
import threading
import time
from array import array

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import harness, program_spans
from portbench.tracing import Card, Slice
from tpu_reductions_torch.obs import spans
from tpu_reductions_torch.ops import dd_reduce as dd
from tpu_reductions_torch.ops import kernel_reduce as kr

NEW = ("program_dispatch_us", "program_plan_us", "program_alloc_us",
       "program_launch_us", "program_finish_us", "program_idle_us")
N = 4096


@pytest.fixture(autouse=True)
def fresh_recorder():
    spans.reset_hot()
    yield
    spans.reset_hot()


@pytest.fixture
def clock(monkeypatch):
    """time.perf_counter_ns counting its readings."""
    real = time.perf_counter_ns
    seen = []

    def counted():
        seen.append(1)
        return real()

    monkeypatch.setattr(time, "perf_counter_ns", counted)
    return seen


def _reduce_fn(method="SUM", dtype="int32", kernel=6):
    stage_fn, reduce_fn = kr.make_staged_reduce(
        method, N, dtype, threads=8, max_blocks=4, kernel=kernel,
        device=torch.device("cpu"))
    x = torch.arange(N, dtype=getattr(torch, dtype))
    return stage_fn(x), reduce_fn, x


def _reader(name):
    return harness.load_module(harness.BENCH_DIR, "metrics", name)


def _commit(stamps, profiled):
    spans.HOT.commit(array("q", stamps), profiled)


# --- the recorder ---------------------------------------------------------

def test_off_records_nothing_and_reads_no_clock(clock):
    x2d, reduce_fn, x = _reduce_fn()
    for _ in range(20):
        assert int(reduce_fn(x2d)) == int(x.sum())
    assert clock == []
    assert not spans.HOT.armed
    assert spans.hot_records(True) == spans.hot_records(False) == []


def test_a_cpu_profiler_arms_it_and_later_calls_go_untraced():
    x2d, reduce_fn, _ = _reduce_fn()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            reduce_fn(x2d)
    assert spans.HOT.armed
    assert len(spans.hot_records(True)) == 3
    assert spans.hot_records(False) == []
    for _ in range(5):
        reduce_fn(x2d)
    traced, untraced = spans.hot_records(True), spans.hot_records(False)
    assert len(traced) == 3 and len(untraced) == 5
    assert traced[-1][spans.END] < untraced[0][spans.START]
    # on the CPU k6 takes its plain version: `reduce` and its finish only
    for rec in traced + untraced:
        assert set(spans.hot_sections(rec)) == {"reduce", "reduce.finish"}
        assert rec[spans.START] <= rec[spans.FINISH_START] <= rec[spans.END]
    spans.disarm_hot()
    reduce_fn(x2d)
    assert len(spans.hot_records(False)) == 5


@pytest.mark.parametrize("kernel", [7, 8, 10])
def test_other_kernels_record_reduce_and_finish(kernel):
    x2d, reduce_fn, x = _reduce_fn("MAX", "int32", kernel)
    spans.arm_hot()
    assert int(reduce_fn(x2d)) == int(x.max())
    (rec,) = spans.hot_records(False)
    assert set(spans.hot_sections(rec)) == {"reduce", "reduce.finish"}


def test_the_pair_routes_reduce_fn_records_reduce_and_finish():
    stage_fn, reduce_fn = dd.make_dd_staged_reduce(
        "SUM", N, threads=8, max_blocks=4, device=torch.device("cpu"))
    x = torch.arange(N, dtype=torch.float64) / 3
    spans.arm_hot()
    assert float(reduce_fn(*stage_fn(x))) == pytest.approx(float(x.sum()),
                                                           rel=1e-15)
    (rec,) = spans.hot_records(False)
    assert set(spans.hot_sections(rec)) == {"reduce", "reduce.finish"}


def test_the_untraced_ring_wraps_at_its_bound(monkeypatch):
    ticks = iter(range(1, 10**7))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    spans.arm_hot()
    calls = spans.UNTRACED_CALLS + 10
    for _ in range(calls):
        spans.hot_begin().end()
    recs = spans.hot_records(False)
    assert len(recs) == spans.UNTRACED_CALLS
    # two readings a call: the ten oldest calls are gone, the rest in order
    assert recs[0][spans.START] == 2 * 10 + 1
    assert recs[-1][spans.END] == 2 * calls
    assert [r[spans.START] for r in recs] == sorted(r[spans.START]
                                                   for r in recs)


def test_the_profiled_ring_wraps_at_its_bound_and_untraced_calls_spare_it():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(spans.PROFILED_CALLS + 3):
            spans.hot_begin().end()
    traced = spans.hot_records(True)
    assert len(traced) == spans.PROFILED_CALLS
    for _ in range(2 * spans.PROFILED_CALLS):
        spans.hot_begin().end()
    assert spans.hot_records(True) == traced
    assert len(spans.hot_records(False)) == 2 * spans.PROFILED_CALLS


def test_a_stamp_with_no_open_record_is_dropped():
    spans.arm_hot()
    rec = spans.HOT.record()
    before = rec.stamps.tolist()
    rec.mark(spans.PLAN_END)
    rec.end()
    assert rec.stamps.tolist() == before
    assert spans.hot_records(False) == []
    # a record already open on the thread: the nested call is not recorded
    outer = spans.hot_begin()
    assert spans.hot_begin() is None
    outer.end()
    assert len(spans.hot_records(False)) == 1


def test_the_chain_core_opens_no_record():
    op, stage_fn, core = kr.make_staged_core("SUM", N, "int32", threads=8,
                                             max_blocks=4,
                                             device=torch.device("cpu"))
    spans.arm_hot()
    x = torch.arange(N, dtype=torch.int32)
    assert int(core(stage_fn(x))) == int(x.sum())
    assert spans.hot_records(False) == []


def test_a_call_that_raises_keeps_no_record_and_frees_the_thread():
    x2d, reduce_fn, _ = _reduce_fn()
    spans.arm_hot()
    with pytest.raises(RuntimeError, match="invalid for input"):
        reduce_fn(torch.zeros((3, 5), dtype=torch.int32))
    assert spans.hot_records(False) == []
    reduce_fn(x2d)
    assert len(spans.hot_records(False)) == 1


def test_two_threads_records_stay_apart():
    """Thread A opens its record, B opens, stamps and ends one inside A's,
    then A ends: two records, each with its own thread's stamps."""
    spans.arm_hot()
    a_open, b_done = threading.Event(), threading.Event()
    stamps = {}

    def a():
        rec = spans.hot_begin()
        a_open.set()
        assert b_done.wait(30)
        rec.mark(spans.FINISH_START)
        stamps["a"] = rec.stamps[spans.FINISH_START]
        rec.end()

    def b():
        assert a_open.wait(30)
        rec = spans.hot_begin()
        assert rec is not None
        rec.mark(spans.FINISH_START)
        stamps["b"] = rec.stamps[spans.FINISH_START]
        rec.end()
        b_done.set()

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    rb, ra = spans.hot_records(False)
    assert rb[spans.FINISH_START] == stamps["b"]
    assert ra[spans.FINISH_START] == stamps["a"]
    assert ra[spans.START] < rb[spans.START] <= rb[spans.END] < ra[spans.END]


def test_threads_hammering_the_recorder_lose_no_record():
    x2d, reduce_fn, _ = _reduce_fn()
    spans.arm_hot()
    workers, each = 12, 150
    errors = []

    def work():
        try:
            for _ in range(each):
                reduce_fn(x2d)
        except Exception as e:      # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    recs = spans.hot_records(False)
    assert len(recs) == workers * each
    for r in recs:
        assert r[spans.START] <= r[spans.FINISH_START] <= r[spans.END]


def test_the_chrome_trace_nests_the_ranges_in_the_callers(tmp_path):
    x2d, reduce_fn, _ = _reduce_fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            reduce_fn(x2d)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    (caller,) = by_name["caller"]
    (red,) = by_name["port.reduce"]
    (fin,) = by_name["port.reduce.finish"]
    assert "port.reduce.plan" not in by_name    # no k6 launch on the CPU

    def inside(inner, outer):
        return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
                <= outer["ts"] + outer["dur"])

    assert inside(red, caller) and inside(fin, red)


# --- the readers ------------------------------------------------------------

def _dispatch_records():
    """Two profiled calls ending at 1000 ns, one untraced call before
    them (left out) and three after, k6 on the card in full."""
    _commit([100, 200, 300, 400, 500, 600], True)
    _commit([700, 800, 850, 900, 950, 1000], True)
    _commit([10, 20, 30, 40, 50, 990], False)       # before the slice ends
    for t0, plan, alloc, launch, fin in [(2000, 10, 5, 20, 8),
                                         (3000, 30, 7, 40, 6),
                                         (4000, 20, 9, 30, 10)]:
        a = t0 + plan * 1000
        b = a + alloc * 1000
        c = b + launch * 1000
        d = c + 1000                                  # 1 us of self time
        _commit([t0, a, b, c, d, d + fin * 1000], False)


def test_dispatch_readers_take_medians_over_calls_after_the_slice():
    _dispatch_records()
    s = Slice(cards=[Card(0.0, 1.0, [], [])], ops=2, bytes=0,
              dispatch_s=[], kind="x")
    want = {"program_plan_us": 20.0, "program_alloc_us": 7.0,
            "program_launch_us": 30.0, "program_finish_us": 8.0,
            "program_dispatch_us": statistics.median([44.0, 84.0, 70.0])}
    for name, value in want.items():
        assert _reader(name).read(s) == pytest.approx(value)
    lines = _reader("program_dispatch_us").lines(s)
    assert len(lines) == 6
    assert lines[0].startswith("program span reduce: 3 untraced calls")
    assert lines[-1].startswith("program span reduce (self): 3 untraced "
                                "calls, median 1.0")


def _idle_slice(ops=2):
    """Two calls at 100 and 400 us of the trace clock; the card busy
    130-160 and 430-480, so idle 0-130, 160-430 and 480-1000."""
    device = [(130.0, 160.0, "k6"), (430.0, 480.0, "k6")]
    calls = [("call", 100.0, 170.0), ("sync", 170.0, 180.0),
             ("call", 400.0, 470.0)]
    return Slice(cards=[Card(0.0, 1000.0, device, calls)], ops=ops,
                 bytes=0, dispatch_s=[], kind="x")


def test_idle_lays_each_record_on_its_call_and_splits_by_section():
    _commit([1, 2, 3, 4, 5, 6], True)               # a warm call: not laid
    # record k: plan 0-10, alloc 10-15, launch 15-40, self 40-41,
    # finish 41-60 us from its start (its start's own clock is any)
    for t0 in (5_000_000, 9_000_000):
        _commit([t0 + 1000 * u for u in (0, 10, 15, 40, 41, 60)], True)
    s = _idle_slice()
    split = program_spans.idle_split(s)
    # call 1 at 100: idle 100-130 inside it: plan 10, alloc 5, launch 15
    # call 2 at 400: idle 400-430: the same
    assert split["reduce.plan"] == pytest.approx(20.0)
    assert split["reduce.alloc"] == pytest.approx(10.0)
    assert split["reduce.launch"] == pytest.approx(30.0)
    assert split["reduce.finish"] == pytest.approx(0.0)
    assert split["reduce"] == pytest.approx(60.0)
    assert split["slice"] == pytest.approx(1000.0 - 80.0)
    assert _reader("program_idle_us").read(s) == pytest.approx(30.0)
    (line,) = _reader("program_idle_us").lines(s)
    assert "reduce.plan 10.0" in line and "reduce.launch 15.0" in line
    # the call spans 100-170 and 400-470 hold idle 100-130, 160-170
    # and 400-430
    assert split["call"] == pytest.approx(70.0)
    assert line.endswith(f"outside the program {(920.0 - 60.0) / 2!r}; "
                         f"inside the benchmark's call span 35.0")


def test_idle_counts_a_gap_only_where_it_meets_a_section():
    # the card busy through each call's plan and alloc, idle from 20 us on
    _commit([7_000_000 + 1000 * u for u in (0, 10, 15, 40, 41, 60)], True)
    device = [(0.0, 120.0, "k")]
    s = Slice(cards=[Card(0.0, 1000.0, device, [("call", 100.0, 170.0)])],
              ops=1, bytes=0, dispatch_s=[], kind="x")
    split = program_spans.idle_split(s)
    # launch 115-140: idle 120-140; self 140-141; finish 141-160
    assert split["reduce.plan"] == 0.0 and split["reduce.alloc"] == 0.0
    assert split["reduce.launch"] == pytest.approx(20.0)
    assert split["reduce (self)"] == pytest.approx(1.0)
    assert split["reduce.finish"] == pytest.approx(19.0)


def test_idle_is_none_where_the_records_do_not_match_the_calls():
    for t0 in (5_000_000, 9_000_000):
        _commit([t0 + 1000 * u for u in (0, 10, 15, 40, 41, 60)], True)
    assert program_spans.idle_split(_idle_slice(ops=3)) is None
    assert _reader("program_idle_us").read(_idle_slice(ops=3)) is None
    assert _reader("program_idle_us").lines(_idle_slice(ops=3)) == []
    spans.reset_hot()
    _commit([1, 2, 3, 4, 5, 6], True)                # one record, two calls
    assert _reader("program_idle_us").read(_idle_slice()) is None


def test_every_reader_gives_none_without_records_or_recorder(monkeypatch):
    s = _idle_slice()
    for name in NEW:
        assert _reader(name).read(s) is None
    _dispatch_records()
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    for name in NEW:
        assert _reader(name).read(s) is None
    assert _reader("program_dispatch_us").lines(s) == []


def test_a_traced_cpu_run_of_the_cell_reports_the_new_metrics():
    cell = harness.resolve(harness.load_spec(), "sdk_reduction.awaited-2e24")
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    cell.traffic = dict(cell.traffic, n={"int32": 4096, "float64": 4096},
                        trace_calls=20, collect_every=8)
    out = harness.run_cell(cell, 2**31 + 7, 0.3, True, platform="cpu")
    line = harness.result_line(cell, out, True, out.window_start - 1.0)
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items() if k in NEW}
    for value in got.values():
        assert math.isfinite(value)
    # the CPU has no k6 launch: its plan, alloc and launch stay absent
    assert set(got) == {"program_dispatch_us", "program_finish_us",
                        "program_idle_us"}
    lines = harness.detail_lines(cell, out, True)
    assert any(t.startswith("program span reduce:") for t in lines)
    assert any(t.startswith("program idle a call") for t in lines)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: run `python -m pytest "
                    "-m gpu --noconftest tests/test_torch_hot_spans.py` on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k6_on_the_card_records_every_section(cuda_device, tmp_path):
    stage_fn, reduce_fn = kr.make_staged_reduce("SUM", 1 << 20, "int32",
                                                device=cuda_device)
    x = torch.arange(1 << 20, dtype=torch.int32, device=cuda_device)
    x2d = stage_fn(x)
    want = int(x.to(torch.int64).sum()) % 2**32
    reduce_fn(x2d)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = reduce_fn(x2d)
    assert int(got) % 2**32 == want
    for _ in range(3):
        reduce_fn(x2d)
    torch.cuda.synchronize()
    for rec in spans.hot_records(True) + spans.hot_records(False):
        sec = spans.hot_sections(rec)
        assert set(sec) == set(spans.HOT_SPANS)
        assert (rec[spans.START] <= rec[spans.PLAN_END]
                <= rec[spans.ALLOC_END] <= rec[spans.LAUNCH_END]
                <= rec[spans.FINISH_START] <= rec[spans.END])
    assert len(spans.hot_records(False)) == 3
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"port." + n for n in spans.HOT_SPANS} <= names
