"""The plain references against hand-worked values, and the payload's
ranges and determinism."""

import math
from fractions import Fraction

import pytest
import torch

from portbench import harness, payload

CPU = torch.device("cpu")


def _ref(name):
    return harness.load_module(harness.BENCH_DIR, "reference", name)


def test_sdk_int32_sum_wraps_modulo_2_32():
    sdk = _ref("sdk_reduction")
    x = torch.tensor([2**31 - 1, 1], dtype=torch.int32)
    assert sdk.expected("SUM", x) == -2**31
    x = torch.full((4,), 2**30, dtype=torch.int32)
    assert sdk.expected("SUM", x) == 0
    x = torch.tensor([-5, 3, 200], dtype=torch.int32)
    assert sdk.expected("SUM", x) == 198


def test_sdk_min_max_are_exact():
    sdk = _ref("sdk_reduction")
    x = torch.tensor([3.5, -0.25, 1e-300, 7.0], dtype=torch.float64)
    assert sdk.expected("MIN", x) == -0.25
    assert sdk.expected("MAX", x) == 7.0
    i = torch.tensor([9, -4, 255], dtype=torch.int32)
    assert (sdk.expected("MIN", i), sdk.expected("MAX", i)) == (-4, 255)


def test_sdk_float64_sum_is_the_exact_sum_rounded_once():
    sdk = _ref("sdk_reduction")
    x = torch.tensor([0.1] * 10 + [1e16, -1e16], dtype=torch.float64)
    want = float(Fraction(0.1) * 10)
    assert sdk.expected("SUM", x) == want
    assert want == math.fsum([0.1] * 10)
    assert float(x.sum()) != want          # the naive order loses the 0.1s


def test_sdk_control_is_float32():
    sdk = _ref("sdk_reduction")
    x = payload.draw(3, 0, 4096, "float64", CPU)
    low = sdk.lowered("SUM", x)
    assert low.dtype == torch.float32
    exact = sdk.expected("SUM", x)
    # float32 holds byte / (2^31 - 1) only to about 2^-31 of itself
    assert abs(float(low) - exact) / exact > 1e-10
    assert sdk.lowered("SUM", payload.draw(3, 1, 64, "int32", CPU)).dtype \
        == torch.int32


def test_sdk_checks_count_and_widest_gap():
    sdk = _ref("sdk_reduction")
    rows = [("SUM", "int32", [(5, 5), (6, 5)]),
            ("MIN", "float64", [(0.5, 0.5)]),
            ("SUM", "float64", [(1.0, 1.0 + 2e-12), (2.0, 2.0)])]
    checks, failed = sdk.checks(rows, {"exact_mismatch": 0,
                                       "f64_sum_gap": 1e-12})
    assert checks["exact_mismatch"] == [1, 0]
    assert checks["f64_sum_gap"][0] == pytest.approx(2e-12)
    assert failed == 2


def test_mpi_reference_is_the_elementwise_op_over_ranks():
    mpi = _ref("mpi_reduce")
    ranks, length = 4, 16
    blocks = {dt: torch.stack([payload.draw(9, payload.stream_of(dt, r),
                                            length, dt, CPU)
                               for r in range(ranks)])
              for dt in ("int32", "float64")}
    got = mpi.expected("int32", 9, ranks, length, CPU)
    b = blocks["int32"]
    assert torch.equal(got["SUM"], b.sum(0, dtype=torch.int64)
                       .to(torch.int32))
    assert torch.equal(got["MIN"], b.amin(0))
    assert torch.equal(got["MAX"], b.amax(0))
    got = mpi.expected("float64", 9, ranks, length, CPU)
    b = blocks["float64"].tolist()
    for j in range(length):
        column = [b[r][j] for r in range(ranks)]
        assert got["SUM"][j].item() == math.fsum(column)
        assert got["MIN"][j].item() == min(column)


def test_mpi_int32_sum_wraps():
    mpi = _ref("mpi_reduce")
    assert mpi._wrap32(torch.tensor([2**31, 2**32 + 7, -2**31 - 1])) \
        .tolist() == [-2**31, 7, 2**31 - 1]


def test_mpi_compare_counts_rank_copies_and_scales_the_gap():
    mpi = _ref("mpi_reduce")
    want = torch.tensor([1, 2, 3], dtype=torch.int32)
    got = torch.stack([want, want.clone()])
    got[1, 2] = 4
    assert mpi.compare("MAX", "int32", got, want) == (1, 0.0)
    want = torch.tensor([1.0, -4.0], dtype=torch.float64)
    got = (want + torch.tensor([0.0, 2e-12], dtype=torch.float64)).expand(2, 2)
    m, gap = mpi.compare("SUM", "float64", got, want)
    assert m == 0 and gap == pytest.approx(2e-12 / 4.0)


def test_payload_ranges_and_determinism():
    a = payload.draw(2**31 + 7, payload.stream_of("int32", 2), 10000,
                     "int32", CPU)
    assert a.dtype == torch.int32
    assert 0 <= int(a.min()) and int(a.max()) <= 255
    assert torch.equal(a, payload.draw(2**31 + 7, payload.stream_of(
        "int32", 2), 10000, "int32", CPU))
    b = payload.draw(2**31 + 7, payload.stream_of("int32", 3), 10000,
                     "int32", CPU)
    assert not torch.equal(a, b)
    f = payload.draw(5, 0, 1000, "float64", CPU)
    k = torch.round(f * payload.RAND_MAX)
    assert torch.equal(f, k / payload.RAND_MAX)
    with pytest.raises(ValueError):
        payload.stream_seed(1, payload.STREAMS)
