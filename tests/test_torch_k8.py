"""k8's schedule (tpu_reductions_torch/csrc/accumulate.cu fold_period),
walked on the host.

Block (g, s) is one team of 256 threads over slot group g; thread t owns
the 16-byte vectors t + j * 256 of the group. The block folds the tiles
s, s + splits, ... in batches of `unroll` loads, each batch combined in
increasing tile order, then the rest one by one; the splits are folded
in split order from the identity, by the last block of the group (one
launch, `fused`) or by a second launch. The walk below follows those
loops and must give every slot exactly the combines of the two-pass order
(tiles s, s + splits, ... into partial s; partials 0, 1, ... into the
accumulator), which is k10's, at every TM, tile count and unroll. Then a
numpy run of the same schedule must equal the plain version and the JAX
package's elementwise_call in interpret mode: bit for bit for int32 and
MIN/MAX, within rtol for float SUM (another order than theirs).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_reductions.ops import pallas_reduce as pr
from tpu_reductions.ops.registry import get_op as jax_get_op
from tpu_reductions_torch.ops import kernel_reduce as kr
from tpu_reductions_torch.ops.registry import get_op

TEAM = 256            # csrc/common.cuh: the threads of a block
SPLIT_BATCH = 8       # csrc/accumulate.cu: partials loaded before combining
SMS = 132
DTYPES = (torch.int32, torch.float32, torch.float64, torch.bfloat16)
PERIOD_TMS = (8, 16, 256, 512, 1024, 2048)
TILE_COUNTS = (1, 3, 8, 64, 65, 512, 1000)
SUM_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12, torch.bfloat16: 1e-2}


def thread_slots(t: int, dtype: torch.dtype) -> list:
    """The slots (row * 128 + column) of a slot group that thread t owns:
    the VEC elements of its vectors t + j * TEAM (csrc/common.cuh
    Layout)."""
    vec = 16 // dtype.itemsize
    loads = kr.sublanes_for(dtype) * 128 // (vec * TEAM)
    return [(t + j * TEAM) * vec + e for j in range(loads)
            for e in range(vec)]


def pass_order(split: int, splits: int, tiles: int, unroll: int) -> list:
    """The tiles block (g, split) combines, in the order it combines them:
    each batch of `unroll` loads in increasing order, then the tail."""
    order = []
    k = split
    while k + (unroll - 1) * splits < tiles:
        order += [k + u * splits for u in range(unroll)]
        k += unroll * splits
    while k < tiles:
        order.append(k)
        k += splits
    return order


def fold_order(splits: int) -> list:
    """The partials the last block of a group combines, batch by batch."""
    return [s0 + b for s0 in range(0, splits, SPLIT_BATCH)
            for b in range(SPLIT_BATCH) if s0 + b < splits]


def launches(plan: kr.PeriodPlan) -> int:
    """CUDA launches of one k8 call (csrc/accumulate.cu K8)."""
    return 1 if plan.splits == 1 or plan.fused else 2


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k8_threads_own_every_slot_of_a_group_once(dtype):
    """256 threads cover the SUB x 128 slots of a group, each once, in
    16-byte vectors: one a thread (two for f64)."""
    owned = [s for t in range(TEAM) for s in thread_slots(t, dtype)]
    assert sorted(owned) == list(range(kr.sublanes_for(dtype) * 128))
    assert len(thread_slots(0, dtype)) * dtype.itemsize in (16, 32)


@pytest.mark.parametrize("unroll", [4, 8, 16])
@pytest.mark.parametrize("dtype, tm", [
    (dtype, tm) for dtype in DTYPES for tm in PERIOD_TMS
    if tm % kr.sublanes_for(dtype) == 0], ids=str)
def test_k8_walk_gives_every_slot_the_two_pass_order(dtype, tm, unroll):
    """Every block's batches and tail combine its split's tiles in
    increasing order, and the splits fold in order: the per-slot sequence
    of combines is the two-pass order, whichever form folds the splits;
    one launch up to K8_MAX_FUSED_SPLITS splits, two above it."""
    sub = kr.sublanes_for(dtype)
    for tiles in TILE_COUNTS:
        plan = kr.plan_k8(tiles, tm, sub, SMS)
        assert plan.splits == kr.plan_splits(tiles, tm, sub, SMS)
        assert plan.fused == (plan.splits <= kr.K8_MAX_FUSED_SPLITS)
        assert launches(plan) == (2 if plan.splits > kr.K8_MAX_FUSED_SPLITS
                                  else 1)
        walked = [tuple(pass_order(s, plan.splits, tiles, unroll))
                  for s in fold_order(plan.splits)]
        two_pass = [tuple(range(s, tiles, plan.splits))
                    for s in range(plan.splits)]
        assert walked == two_pass
        assert sorted(k for split in walked for k in split) == list(
            range(tiles))
        assert plan == kr.plan_k8(tiles, tm, sub, SMS)


def test_k8_plan_at_the_main_path_shape():
    """int32 n = 2^24 at TM 256: 512 tiles over 32 slot groups x 8
    splits (256 blocks, about two an SM), folded in the one launch; bf16
    at TM 256: 16 groups x 16 splits; TM 8: 264 splits, two launches."""
    assert kr.plan_k8(512, 256, 8, SMS) == kr.PeriodPlan(8, kr.K8_UNROLL,
                                                         True)
    assert kr.plan_k8(512, 256, 16, SMS).splits == 16
    assert kr.plan_k8(16384, 8, 8, SMS) == kr.PeriodPlan(264, kr.K8_UNROLL,
                                                         False)
    assert kr.plan_k8(4, 2048, 8, SMS) == kr.PeriodPlan(1, kr.K8_UNROLL,
                                                        True)
    assert kr.K8_UNROLL in kr.K8_UNROLLS


def test_ticket_buffer_covers_every_slot_group():
    """A fused launch takes one ticket per slot group: the stream's
    buffer holds the most groups of any dtype and TM (TM 2048 of 8-row
    groups), and dd's pass-2 ticket after them."""
    most = max(tm // kr.sublanes_for(dtype) for dtype in DTYPES
               for tm in PERIOD_TMS if tm % kr.sublanes_for(dtype) == 0)
    assert most == 256
    assert kr.TICKETS >= most + 1
    biggest = kr.choose_tiling(1 << 30, 1 << 20, 64, torch.int32)[0]
    assert biggest // 8 <= most


def _combine(method: str, dtype: torch.dtype):
    """The kernel's combine (csrc/common.cuh) on numpy arrays of the
    register type: int32 SUM wraps through uint32, bf16 SUM adds in f32,
    MIN takes b where b < a, MAX b where a < b."""
    if method == "SUM":
        if dtype == torch.int32:
            return lambda a, b: (a.view(np.uint32) + b.view(np.uint32)
                                 ).view(np.int32)
        return lambda a, b: a + b
    if method == "MIN":
        return lambda a, b: np.where(b < a, b, a)
    return lambda a, b: np.where(a < b, b, a)


def k8_numpy(x2d: np.ndarray, method: str, dtype: torch.dtype, tm: int,
             plan: kr.PeriodPlan) -> np.ndarray:
    """The accumulator the schedule computes, in numpy: every slot of a
    tile follows the same sequence, so whole tiles are combined at once."""
    reg = np.float32 if dtype == torch.bfloat16 else x2d.dtype
    tiles = x2d.reshape(-1, tm, 128).astype(reg)
    combine = _combine(method, dtype)
    identity = np.full((tm, 128), get_op(method).identity(
        torch.float32 if dtype == torch.bfloat16 else dtype), dtype=reg)
    parts = []
    for s in range(plan.splits):
        acc = identity.copy()
        for k in pass_order(s, plan.splits, tiles.shape[0], plan.unroll):
            acc = combine(acc, tiles[k])
        parts.append(acc)
    acc = identity.copy()
    for s in fold_order(plan.splits):
        acc = combine(acc, parts[s])
    return acc


def _payload(n: int, dtype: torch.dtype, method: str) -> np.ndarray:
    rng = np.random.default_rng(n)
    if dtype == torch.int32:
        return rng.integers(-2**31, 2**31, size=n).astype(np.int32)
    x = rng.random(n) if method == "SUM" else rng.standard_normal(n)
    if dtype == torch.bfloat16:
        return x.astype(ml_dtypes.bfloat16)
    return x.astype(np.float32 if dtype == torch.float32 else np.float64)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor with the same bits."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


# (tiles, TM, SMs): fused splits with a ragged tail (65 tiles over 4, or
# 8 for bf16), two batches a split (64 over 4), splits above
# K8_MAX_FUSED_SPLITS (65 over 65), one split, and TM 256's 8 splits
SCHEDULE_CASES = ((65, 16, 4), (64, 16, 4), (65, 16, SMS), (3, 256, 1),
                  (16, 256, SMS))


@pytest.mark.parametrize("tiles, tm, sms", SCHEDULE_CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
def test_k8_schedule_equals_plain_and_pallas(method, dtype, tiles, tm, sms):
    """The schedule run in numpy against elementwise_plain and the JAX
    elementwise_call (interpret mode) on one identity-padded ragged
    payload."""
    sub = kr.sublanes_for(dtype)
    if tm % sub:
        pytest.skip(f"TM {tm} is not whole {sub}-row groups")
    op = get_op(method)
    n = tiles * tm * 128 - 37
    x = _payload(n, dtype, method)
    x2d = kr.stage_padded(_to_torch(x), tm, tiles, 1, op)
    plan = kr.plan_k8(tiles, tm, sub, sms)
    staged = (x2d.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
              if dtype == torch.bfloat16 else x2d.numpy())
    got = k8_numpy(staged, method, dtype, tm, plan).astype(np.float64)
    plain = kr.elementwise_plain(x2d, op, tm).double().numpy()
    pallas = np.asarray(pr.elementwise_call(
        jnp.asarray(staged), jax_get_op(method), tm, interpret=True))
    assert got.shape == plain.shape == pallas.shape == (tm, 128)
    for want in (plain, pallas.astype(np.float64)):
        if dtype == torch.int32 or method != "SUM":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=SUM_RTOL[dtype])
