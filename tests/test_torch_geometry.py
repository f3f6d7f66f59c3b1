"""The geometry of the port's k6 and k7 pass (csrc/reduce.cu fold_span),
planned on the host by tpu_reductions_torch/ops/kernel_reduce.plan_k6 and
plan_k7, and k7's plain version on partials that are not padded; k10's,
k9's and dd's plans (plan_k10, plan_k9, dd_reduce.plan_dd) likewise.

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
from tpu_reductions_torch.ops import dd_reduce as dd
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


def ring_walk(count: int, chunks: int, depth: int) -> list:
    """Walk k10's ring as csrc/accumulate.cu stream_period does for one
    block of `count` chunks: stage q fills slot q % depth with chunks
    [q*chunks, min((q+1)*chunks, count)). Checks the barrier parities the
    kernel tracks with its `lap` bit: the consumers wait for the full
    barrier's completion number q // depth of that slot, and the producer
    refills a slot only after its empty barrier completed for the stage
    depth before. Returns the chunk indices in the order they are
    folded."""
    folded = []
    slot, lap = 0, 0
    released = [0] * depth      # completions of each empty barrier
    filled = [0] * depth        # completions of each full barrier
    for q in range(-(-count // chunks)):
        assert slot == q % depth and lap == (q // depth) & 1
        if q >= depth:
            # the producer waits on parity lap ^ 1: the release of use
            # q // depth - 1 of this slot, by the stage depth before
            assert released[slot] == q // depth
            assert (released[slot] - 1) & 1 == lap ^ 1
        # consumers wait on parity lap: this slot's fill number q // depth
        assert filled[slot] == q // depth and filled[slot] & 1 == lap
        filled[slot] += 1
        first = q * chunks
        folded.extend(range(first, min(first + chunks, count)))
        released[slot] += 1
        slot += 1
        if slot == depth:
            slot, lap = 0, lap ^ 1
    return folded


PERIOD_TMS = (8, 16, 256, 512, 1024, 2048)
TILE_COUNTS = (1, 3, 8, 64, 65, 512, 1000)


@pytest.mark.parametrize("dtype, tm", [
    (dtype, tm) for dtype in (torch.int32, torch.float32, torch.float64,
                              torch.bfloat16)
    for tm in PERIOD_TMS if tm % kr.sublanes_for(dtype) == 0])
def test_k10_plan_folds_every_tile_once_in_k8_order(dtype, tm):
    """Every tile is folded once, by the split k8 gives it, in increasing
    order, at every depth the CLI, the races and the tests use: the order
    of adds per slot does not depend on the depth."""
    sub = kr.sublanes_for(dtype)
    deepest = kr.stream_max_depth(dtype)
    for tiles in TILE_COUNTS:
        splits = kr.plan_splits(tiles, tm, sub, SMS)
        orders = set()
        for depth in (1, 2, 4, 8, deepest):
            plan = kr.plan_k10(tiles, tm, sub, dtype.itemsize, depth, SMS)
            assert (plan.splits, plan.depth) == (splits, depth)
            chunk = sub * 128 * dtype.itemsize
            assert plan.chunks * chunk <= kr.STREAM_STAGE_BYTES
            assert (depth * plan.chunks * chunk + kr.STREAM_BARRIER_BYTES
                    <= kr.SMEM_PER_BLOCK)
            order = []
            for split in range(plan.splits):
                count = len(range(split, tiles, plan.splits))
                walked = ring_walk(count, plan.chunks, depth)
                assert walked == list(range(count))
                order.append(tuple(split + i * plan.splits for i in walked))
            flat = sorted(k for split in order for k in split)
            assert flat == list(range(tiles))      # each tile once
            assert all(list(s) == sorted(s) for s in order)
            orders.add(tuple(order))
            assert plan == kr.plan_k10(tiles, tm, sub, dtype.itemsize, depth,
                                       SMS)
        assert len(orders) == 1


@pytest.mark.parametrize("tm", PERIOD_TMS)
@pytest.mark.parametrize("sms", [1, 66, 132])
def test_period_splits_fill_one_wave(tm, sms):
    """k8's and k10's splits: the tm/sub slot groups x splits blocks fit
    one wave of two blocks per SM (or take one split), never more splits
    than tiles; a function of the shape and the SM count alone."""
    for sub in (8, 16):
        if tm % sub:
            continue
        for tiles in TILE_COUNTS:
            splits = kr.plan_splits(tiles, tm, sub, sms)
            assert 1 <= splits <= tiles
            assert tm // sub * splits <= 2 * sms or splits == 1
            assert splits == kr.plan_splits(tiles, tm, sub, sms)


def test_k10_plan_at_the_main_path_shape():
    """int32 n = 2^24 at TM 256: 512 tiles, 32 slot groups x 8 splits,
    two 4 KiB chunks a stage, 32 KiB of ring at depth 4."""
    assert kr.plan_k10(512, 256, 8, 4, 4, SMS) == kr.StreamPlan(
        splits=8, depth=4, chunks=2)


def test_k10_plan_refuses_a_ring_that_does_not_fit():
    deepest = kr.stream_max_depth(torch.float64)
    kr.plan_k10(64, 256, 8, 8, deepest, SMS)
    with pytest.raises(ValueError, match=f"at most {deepest} stages"):
        kr.plan_k10(64, 256, 8, 8, deepest + 1, SMS)


def mxu_runs(plan: kr.MxuPlan, slabs: int) -> list:
    """The slab ranges the warps fold, as csrc/mxu.cu mxu_columns walks
    them: warp w of the grid takes [w*run, min((w+1)*run, slabs))."""
    ranges = []
    for w in range(plan.blocks * kr.MXU_WARPS):
        first, end = w * plan.run, min((w + 1) * plan.run, slabs)
        if end > first:
            ranges.append((first, end))
    return ranges


@pytest.mark.parametrize("sms", [1, 66, 132])
@pytest.mark.parametrize("slabs", [1, 2, 15, 16, 17, 125, 2112, 2113, 8192,
                                   16384, 16384 + 7, 32768, 1 << 20])
def test_k9_plan_splits_the_slabs_evenly(slabs, sms):
    """Every slab once, in equal contiguous runs (the last may be
    shorter), one block of MXU_WARPS warps per SM at most, no block
    without a run; a function of the slab count and the SM count."""
    plan = kr.plan_k9(slabs, sms)
    runs = mxu_runs(plan, slabs)
    assert covers_once(runs, slabs)
    assert all(end - first == plan.run for first, end in runs[:-1])
    assert 1 <= runs[-1][1] - runs[-1][0] <= plan.run
    # the last block holds the last run; none holds no run
    assert plan.blocks == -(-len(runs) // kr.MXU_WARPS) <= sms
    # no fewer runs than warps could take them: a shorter run would not fit
    assert plan.run == -(-slabs // min(slabs, sms * kr.MXU_WARPS))
    assert plan == kr.plan_k9(slabs, sms)


def test_k9_plan_at_the_main_path_shape():
    """float32 n = 2^24: 16384 slabs of 8 rows in 2048 runs of 8 (the
    parent's grid-stride walk gave 2112 warps 7 or 8), 128 blocks."""
    plan = kr.plan_k9(16384, SMS)
    assert plan == kr.MxuPlan(run=8, blocks=128)
    assert len(mxu_runs(plan, 16384)) == 2048


def test_k7_refuses_more_rows_than_its_tiling():
    x2d = torch.zeros((64, 128), dtype=torch.int32)
    for call in (kr.two_pass_call, kr.two_pass_plain):
        with pytest.raises(ValueError, match="rows for tiling"):
            call(x2d, get_op("SUM"), 8, 4, 1)


# --- dd (csrc/pair.cu), planned by dd_reduce.plan_dd ------------------------

# chip_smoke.py's two payload sizes; every TM --threads can give
DD_SIZES = (1 << 24, (1 << 24) + 37)
DD_TMS = range(8, 2049, 8)


def dd_tile_walk(plan: dd.DdPlan, tiles: int) -> list:
    """The tiles each split folds, as fold_tiles walks them: s, s +
    splits, ... < tiles."""
    return [list(range(s, tiles, plan.splits)) for s in range(plan.splits)]


@pytest.mark.parametrize("sms", [1, 66, 132])
@pytest.mark.parametrize("n", DD_SIZES)
def test_dd_plan_sound_for_every_tm(n, sms):
    """For every TM of the two chip sizes: every tile folded by one
    split, in increasing order, no split empty; pass 1 at most
    DD_CTAS_PER_SM CTAs an SM (or one split) and at most DD_MAX_SPLITS
    partials for the last CTA of a group to fold; pass 2 a power of two
    of whole CTAs whose J leaves a thread cover the padded accumulator,
    within the kernel's register arrays; the last CTA's share too; a
    function of the shape and the SM count alone."""
    for threads in DD_TMS:
        tm, p, t = kr.choose_tiling(n, threads, 64)
        tiles = p * t
        plan = dd.plan_dd(tiles, tm, sms)
        assert plan == dd.plan_dd(tiles, tm, sms)
        walk = dd_tile_walk(plan, tiles)
        assert sorted(k for split in walk for k in split) == \
            list(range(tiles))
        assert all(split and split == sorted(split) for split in walk)
        assert 1 <= plan.splits <= min(tiles, dd.DD_MAX_SPLITS)
        assert (tm // 8 * plan.splits <= dd.DD_CTAS_PER_SM * sms
                or plan.splits == 1)
        padded = 1 << (tm * 128 - 1).bit_length()
        r = plan.residues
        assert r & (r - 1) == 0 and r % dd.DD_TEAM == 0
        assert padded % r == 0 and padded // r <= dd.DD_MAX_LEAVES
        assert r // dd.DD_TEAM <= dd.DD_MAX_TAIL


def test_dd_plan_at_the_main_path_shape():
    """float64 n = 2^24 at TM 256: 512 tiles, 32 slot groups x 8 splits
    (256 CTAs, two an SM); 8192 pass-2 threads of 4 leaves each over the
    32768 pairs, 32 CTAs, whose 8192 pairs the last CTA folds 32 a
    thread."""
    assert dd.plan_dd(512, 256, SMS) == dd.DdPlan(splits=8, residues=8192)


def test_dd_out_words_holds_every_piece():
    """The launch's buffer: the accumulator's two planes, the scalar pair
    and its padding, the partials (with splits) and the tree; the
    partials start on a 16-byte boundary. The tickets hold one per slot
    group of the largest TM, and pass 2's."""
    for tm in (8, 200, 256, 2048):
        for plan in (dd.DdPlan(1, 256), dd.DdPlan(4, 4096)):
            size = tm * 128
            parts = 2 * plan.splits * size if plan.splits > 1 else 0
            assert dd._out_words(tm, plan) == \
                2 * size + 4 + parts + 2 * plan.residues
            assert (2 * size + 4) * 4 % 16 == 0
        assert tm // 8 + 1 <= kr.TICKETS
