"""The geometry of the port's k6 and k7 pass (csrc/reduce.cu fold_span),
planned on the host by tpu_reductions_torch/ops/kernel_reduce.plan_k6 and
plan_k7, and k7's plain version on partials that are not padded.

The planners are pure functions of the shape, the SM count and the
device's cluster occupancy, so they are tested here for every shape
class, without a card: every row is folded by exactly one CTA, every
share is whole sub-row groups, the grid fits one wave of resident CTAs
(or takes one CTA per partial block), no cluster is larger than the
portable 8 nor splits a span into shares under MIN_GROUPS groups, and
the same inputs always give the same plan.
"""

import numpy as np
import pytest
import torch

from tpu_reductions_torch.bench.passes import bits
from tpu_reductions_torch.ops import kernel_reduce as kr
from tpu_reductions_torch.ops.registry import get_op

DTYPES = ("int32", "float32", "float64", "bfloat16")
METHODS = ("SUM", "MIN", "MAX")
# cudaOccupancyMaxActiveClusters at 8 CTAs: a card holding one cluster,
# a part-filled card, the H100's 30 (PERF.md), and 132 SMs x 3 CTAs / 8
ACTIVE = (1, 16, 30, 49)
SMS = 132
P_CLASSES = (1, 2, 3, 64, 132, 1000)


def owners(plan: kr.SpanPlan, rows: int, sub: int) -> list:
    """The row ranges the CTAs fold, walking the plan as fold_span does:
    block i's rank s folds [i*span + s*share, +share), cut at the end of
    the block's span and of the array; each bound is a whole group."""
    ranges = []
    for block in range(plan.blocks):
        for rank in range(plan.cluster):
            first = block * plan.span + rank * plan.share
            end = min(first + plan.share, (block + 1) * plan.span, rows)
            if end > first:
                assert first % sub == 0 and end % sub == 0
                ranges.append((first, end))
    return sorted(ranges)


def covers_once(ranges: list, rows: int) -> bool:
    """The ranges tile [0, rows): none overlaps, none leaves a gap."""
    ends = [0] + [end for _, end in ranges]
    return (all(first == end for (first, _), end in zip(ranges, ends))
            and ends[-1] == rows)


def assert_plan_sound(plan: kr.SpanPlan, rows: int, sub: int,
                      active: int) -> None:
    assert 1 <= plan.cluster <= kr.CLUSTER
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.span % sub == 0 and plan.share % sub == 0
    assert plan.share * plan.cluster >= plan.span
    assert (plan.blocks * plan.cluster <= active * kr.CLUSTER
            or plan.cluster == 1)
    # a CTA of a cluster larger than one has MIN_GROUPS groups or more
    assert plan.cluster == 1 or plan.share // sub >= kr.MIN_GROUPS
    assert covers_once(owners(plan, rows, sub), rows)


@pytest.mark.parametrize("active", ACTIVE)
@pytest.mark.parametrize("sub", [8, 16])
@pytest.mark.parametrize("p", P_CLASSES)
def test_k7_plan_covers_every_row_once(p, sub, active):
    """k7 keeps the tiling's P blocks of T*TM rows; the array may stop
    short of P*T*TM (the chain's unpadded partials), raggedly."""
    for tm, t in ((sub, 1), (256, 3), (2048, 1), (2048, 64)):
        span = t * tm
        full = p * span
        for rows in sorted({full, full - sub, max(sub, full // 2 // sub
                                                  * sub), sub}):
            plan = kr.plan_k7(rows, sub, p, span, SMS, active)
            assert (plan.blocks, plan.span) == (p, span)
            assert_plan_sound(plan, rows, sub, active)
            assert plan == kr.plan_k7(rows, sub, p, span, SMS, active)


@pytest.mark.parametrize("p, span, cluster", [
    (64, 2048, 1),    # the default --maxblocks at n = 2^24: 64 CTAs fill
    (32, 2048, 2), (33, 2048, 2), (16, 2048, 4),
    (2, 65536, 8), (1, 131072, 8),     # --maxblocks 2 and 1 at n = 2^24
    (16, 512, 1),     # 64 groups a block: no share of 64 to cut off
    (2, 256, 1), (1, 256, 1),          # the chain's last passes
    (132, 2048, 1), (1000, 2048, 1)])
def test_k7_splits_a_span_only_when_the_blocks_cannot_fill(p, span,
                                                             cluster):
    plan = kr.plan_k7(p * span, 8, p, span, SMS, 30)
    assert plan.cluster == cluster


@pytest.mark.parametrize("active", ACTIVE)
@pytest.mark.parametrize("sub", [8, 16])
@pytest.mark.parametrize("groups", [1, 2, 63, 64, 127, 128, 1000, 4097,
                                    16384, 16384 + 5])
def test_k6_plan_covers_every_row_once(groups, sub, active):
    rows = groups * sub
    plan = kr.plan_k6(rows, sub, SMS, active)
    ctas = plan.blocks * plan.cluster
    assert ctas <= max(kr.CLUSTER, min(SMS // 2, active * kr.CLUSTER))
    # no empty cluster, and no CTA under MIN_GROUPS unless alone
    assert (plan.blocks - 1) * plan.span < rows
    assert ctas == 1 or rows // sub >= ctas * kr.MIN_GROUPS
    assert_plan_sound(plan, rows, sub, active)
    assert plan == kr.plan_k6(rows, sub, SMS, active)


def test_k6_plan_at_the_main_path_shape():
    """int32 n = 2^24: 131072 rows over 64 CTAs, 8 clusters of 8."""
    plan = kr.plan_k6(131072, 8, SMS, 30)
    assert (plan.blocks, plan.cluster) == (8, 8)
    assert plan.blocks * plan.span >= 131072 > (plan.blocks - 1) * plan.span


def test_planners_refuse_what_fold_span_cannot_run():
    with pytest.raises(ValueError, match="no cluster"):
        kr.plan_k6(64, 8, SMS, 0)
    with pytest.raises(ValueError, match="no cluster"):
        kr.plan_k7(64, 8, 4, 16, SMS, 0)
    with pytest.raises(ValueError, match="cannot cover"):
        kr.plan_k7(72, 8, 4, 16, SMS, 30)


def _payload(n, dtype, method, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-2**31, 2**31, size=n)
                                .astype(np.int32))
    x = torch.from_numpy(rng.random(n) if method == "SUM"
                         else rng.standard_normal(n))
    return x.to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
def test_two_pass_plain_pads_unpadded_partials(method, dtype):
    """A chain pass on the partials as they are gives, bit for bit, the
    same partials as on their identity-padded copy (the JAX chain's
    stage_padded), for every op x dtype pair."""
    op = get_op(method)
    n, threads, max_blocks = 65536 + 5, 64, 64
    x = _payload(n, dtype, method)
    x2d = kr.stage_padded(x, *kr.choose_tiling(n, threads, max_blocks,
                                               x.dtype), op)
    partials = kr.two_pass_plain(x2d, op, *kr.choose_tiling(
        n, threads, max_blocks, x.dtype))
    sub2 = kr.sublanes_for(partials.dtype)
    mb2 = max(1, min(max_blocks, partials.shape[0] // (2 * sub2)))
    tm2, p2, t2 = kr.choose_tiling(partials.numel(), threads, mb2,
                                   partials.dtype)
    assert partials.shape[0] < p2 * t2 * tm2        # padding is needed
    padded = kr.stage_padded(partials, tm2, p2, t2, op)
    got = kr.two_pass_plain(partials, op, tm2, p2, t2)
    want = kr.two_pass_plain(padded, op, tm2, p2, t2)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(kr.two_pass_call(partials, op, tm2, p2, t2)),
                       bits(want))


def test_k7_refuses_more_rows_than_its_tiling():
    x2d = torch.zeros((64, 128), dtype=torch.int32)
    for call in (kr.two_pass_call, kr.two_pass_plain):
        with pytest.raises(ValueError, match="rows for tiling"):
            call(x2d, get_op("SUM"), 8, 4, 1)
