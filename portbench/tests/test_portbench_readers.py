"""The per-layer and end-to-end readers on synthetic records: busy union,
idle, the roofline's arithmetic, NCCL's share, the 95th percentile over
all calls, and the breakdown."""

import statistics

import pytest

from portbench import harness, yardstick
from portbench.tracing import Card, Slice, breakdown

H100 = "NVIDIA H100 80GB HBM3"


def _reader(folder, name):
    return harness.load_module(harness.BENCH_DIR, folder, name)


def test_union_merges_overlaps_and_clips():
    ivs = [(0, 10), (5, 15), (20, 30), (40, 50)]
    assert yardstick.union_length(ivs, 0, 100) == 35
    assert yardstick.union_length(ivs, 8, 25) == 12    # 8-15 and 20-25
    assert yardstick.union_length([], 0, 10) == 0


def test_gaps_are_the_complement_of_the_union():
    ivs = [(2, 4), (3, 6), (8, 9)]
    assert yardstick.gaps(ivs, 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert sum(e - s for s, e in yardstick.gaps(ivs, 0, 10)) == \
        10 - yardstick.union_length(ivs, 0, 10)


def test_p95_is_over_every_value():
    values = list(range(1, 101))
    assert yardstick.p95(values) == statistics.quantiles(values, n=20)[18]
    assert yardstick.p95([7.0]) == 7.0
    # one slow call in twenty moves it; the median does not
    assert yardstick.p95([1.0] * 18 + [50.0] * 2) > 1.0


def test_spread_is_the_quartiles_over_the_median():
    q1, q2, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert yardstick.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == \
        pytest.approx((q3 - q1) / q2)


def _sdk_slice(device, spans, ops, nbytes, dispatch=(20e-6,)):
    return Slice(cards=[Card(0.0, 1000.0, device, spans)], ops=ops,
                 bytes=nbytes, dispatch_s=list(dispatch), kind=H100)


def test_roofline_is_least_time_over_busy_time():
    # two calls, each 335 MB: 100 us at 3.35 TB/s; the card is busy
    # 250 us in all (one kernel of 200 us overlapping one of 100 us)
    device = [(0, 200, "k6"), (150, 250, "finish")]
    s = _sdk_slice(device, [("call", 0, 300)], 2, 2 * 335_000_000)
    got = _reader("metrics", "reduce_roofline_pct").read(s)
    assert got == pytest.approx(100.0 * 200e-6 / 250e-6)


def test_roofline_leaves_out_the_check_and_unknown_cards():
    device = [(0, 100, "k6"), (500, 900, "stack")]
    spans = [("call", 0, 120), ("collect", 490, 950)]
    s = _sdk_slice(device, spans, 1, 335_000_000)
    assert _reader("metrics", "reduce_roofline_pct").read(s) == \
        pytest.approx(100.0)
    s.kind = "some other card"
    assert _reader("metrics", "reduce_roofline_pct").read(s) is None


def test_kernels_per_call_counts_the_calls_work_only():
    device = [(0, 10, "a"), (10, 20, "b"), (30, 40, "c"), (600, 610, "d")]
    spans = [("call", 0, 5), ("sync", 5, 45), ("collect", 590, 620)]
    s = _sdk_slice(device, spans, 1, 0)
    assert _reader("metrics", "kernels_per_call").read(s) == 3


def test_idle_is_one_minus_busy_over_the_slice():
    s = _sdk_slice([(0, 250, "k"), (500, 750, "k")], [], 2, 0)
    assert _reader("metrics", "device_idle_pct.sdk").read(s) == \
        pytest.approx(50.0)
    s.cards[0].device = []
    assert _reader("metrics", "device_idle_pct.sdk").read(s) is None


def test_dispatch_is_the_mean_host_time_in_us():
    s = _sdk_slice([], [], 3, 0, dispatch=(10e-6, 20e-6, 30e-6))
    assert _reader("metrics", "dispatch_us").read(s) == pytest.approx(20.0)


def _mpi_slice():
    cards = []
    for c in range(4):
        busy = 100.0 * (c + 1)          # card c busy (c + 1) tenths
        cards.append(Card(0.0, 1000.0,
                          [(0, busy / 2, "ncclDevKernel_AllReduce"),
                           (busy / 2, busy, "index_select"),
                           (950, 960, "copy")],
                          [("collective", 0, 900), ("collect", 940, 990)]))
    return Slice(cards=cards, ops=2, bytes=0, dispatch_s=[], kind=H100)


def test_mpi_idle_is_the_mean_over_the_cards():
    s = _mpi_slice()
    idle = [100.0 * (1 - (100.0 * (c + 1) + 10) / 1000) for c in range(4)]
    mod = _reader("metrics", "device_idle_pct.mpi")
    assert mod.read(s) == pytest.approx(sum(idle) / 4)
    assert len(mod.lines(s)) == 4


def test_nccl_share_and_local_time_read_the_collectives_work():
    s = _mpi_slice()
    # card 0: 50 us NCCL, 50 us index_select in the collective; the copy
    # in `collect` is the check's, not the collective's
    assert _reader("metrics", "nccl_pct.mpi").read(s) == pytest.approx(50.0)
    assert _reader("metrics", "local_ms_per_op.mpi").read(s) == \
        pytest.approx(50e-6 / 2 * 1e3)


def test_end_to_end_readers():
    window = {"seconds": 2.0, "bytes": 4e9, "ops": 4,
              "latencies_s": [1e-4] * 19 + [3e-4]}
    assert _reader("end_to_end", "reduce_gbps").read(window) == 2.0
    assert _reader("end_to_end", "mpi_reduce_gbps").read(window) == 2.0
    p = yardstick.p95(window["latencies_s"])
    assert _reader("end_to_end", "reduce_p95_us").read(window) == \
        pytest.approx(p * 1e6)
    assert _reader("end_to_end", "mpi_reduce_p95_ms").read(window) == \
        pytest.approx(p * 1e3)


def test_breakdown_ranks_ops_and_names_idle_by_open_span():
    card = Card(0.0, 100.0,
                [(0, 30, "k6"), (40, 50, "finish"), (60, 70, "k6")],
                [("call", 0, 35), ("sync", 35, 55), ("rotate", 55, 58),
                 ("call", 58, 100)])
    b = breakdown(card)
    assert b["device_ops"][0] == ["k6", pytest.approx(40e-6)]
    idle = dict(b["idle_gaps"])
    assert idle["sync"] == pytest.approx(10e-6)      # 30-40, mid 35
    assert idle["rotate"] == pytest.approx(10e-6)    # 50-60, mid 55
    assert idle["call"] == pytest.approx(30e-6)      # 70-100
    assert sum(idle.values()) == pytest.approx(100e-6 - 50e-6)
