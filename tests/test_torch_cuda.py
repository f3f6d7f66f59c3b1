"""The port's CUDA kernels (k6-k10 and dd) on the card, against their
plain versions, and the streaming pipeline on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports neither jax nor tpu_reductions, so it also runs on a machine
without JAX, with the repository's conftest.py (which imports jax) left
out:

    python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

int32 and MIN/MAX must be bit-equal; float SUM adds in another order and
is held to rtol 1e-6 (float32), 1e-12 (float64), 1e-2 (bfloat16 data,
float32 accumulator). k10 must give the same bits at every depth, and the
same bits as k8; k8 the same bits on every call, on any stream. dd is held to the rule in csrc/pair.cu: MIN/MAX
bit-equal, SUM per slot within 2 (d - 1) 4u^2 sum|x| of dd_plain; its
fused pair finish bit-equal to the torch tree over its own accumulator.
"""

import numpy as np
import pytest
import torch

from tpu_reductions_torch.bench.passes import bits
from tpu_reductions_torch.ops import kernel_reduce as kr
from tpu_reductions_torch.ops.registry import get_op

DTYPES = ("int32", "float32", "float64", "bfloat16")
METHODS = ("SUM", "MIN", "MAX")
SUM_RTOL = {"float32": 1e-6, "float64": 1e-12, "bfloat16": 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: run `python -m pytest "
                    "-m gpu --noconftest tests/test_torch_cuda.py` on the "
                    "card")
    return torch.device("cuda")


def payload(n, dtype, method, seed=0) -> torch.Tensor:
    """numpy-seeded: full-range int32 (SUM wraps), non-negative reals for
    SUM, signed reals for MIN/MAX."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-2**31, 2**31, size=n)
                                .astype(np.int32))
    x = torch.from_numpy(rng.random(n) if method == "SUM"
                         else rng.standard_normal(n))
    return x.to(getattr(torch, dtype))


def assert_acc_match(got: torch.Tensor, want: torch.Tensor, method, dtype):
    got = got.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == "int32" or method != "SUM":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.double().numpy(),
                                   want.double().numpy(),
                                   rtol=SUM_RTOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("n, threads, max_blocks", [
    (300_001, 64, 16), (1000, 8, 4), (65536, 8, 1000)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
def test_kernels_match_plain(cuda_device, method, dtype, n, threads,
                             max_blocks):
    """k6, and k7 with its multi-pass chain, against the plain versions
    (run on a CPU copy of the same staged tensor); the launch counters
    rise by one per k6 call and one per k7 pass."""
    op = get_op(method)
    x = payload(n, dtype, method)
    tm, p, t = kr.choose_tiling(n, threads, max_blocks, x.dtype)
    x2d = kr.stage_padded(x, tm, p, t, op, cuda_device)
    host = x2d.cpu()
    k6_before = kr.single_pass_call.launches
    assert_acc_match(kr.single_pass_call(x2d, op),
                     kr.single_pass_plain(host, op), method, dtype)
    assert kr.single_pass_call.launches == k6_before + 1
    k7_before = kr.two_pass_call.launches
    got = kr._multipass_finish(kr.two_pass_call(x2d, op, tm, p, t), op,
                               threads, max_blocks, 1)
    passes = kr.two_pass_call.launches - k7_before
    want = kr._multipass_finish(kr.two_pass_plain(host, op, tm, p, t), op,
                                threads, max_blocks, 1)
    assert_acc_match(got, want, method, dtype)
    assert passes >= 1
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_take(cuda_device):
    op = get_op("SUM")
    x2d = torch.zeros((64, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kr.single_pass_call(x2d.t().contiguous().t(), op)
    with pytest.raises(ValueError, match="multiple of 8"):
        kr.single_pass_call(x2d[:60], op)
    # k7 takes fewer rows than its tiling covers, never more
    with pytest.raises(ValueError, match="rows for tiling"):
        kr.two_pass_call(x2d, op, 8, 4, 1)
    with pytest.raises(ValueError, match="no kernel for dtype"):
        kr.single_pass_call(x2d.to(torch.int64), op)
    # the 16-byte loads need a 16-byte aligned base
    skewed = x2d.view(-1)[1:1 + 56 * 128].view(56, 128)
    with pytest.raises(ValueError, match="16-byte"):
        kr.single_pass_call(skewed, op)
    with pytest.raises(ValueError, match="16-byte"):
        kr.two_pass_call(skewed, op, 8, 7, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_k6_k7_repeat_their_bits(cuda_device, dtype):
    """No float atomics, and an order fixed by the shape: the same staged
    tensor gives the same bits on every call, float SUM included, for k6
    and for the k7 chain, at the default --maxblocks and at 2 (where k7
    folds each span with a cluster of CTAs)."""
    op = get_op("SUM")
    n = (1 << 22) + 37
    x = payload(n, dtype, "SUM", seed=8)
    for max_blocks in (64, 2):
        tm, p, t = kr.choose_tiling(n, 256, max_blocks, x.dtype)
        x2d = kr.stage_padded(x, tm, p, t, op, cuda_device)

        def chain():
            return kr._multipass_finish(kr.two_pass_call(x2d, op, tm, p, t),
                                        op, 256, max_blocks, 1)

        first6, first7 = bits(kr.single_pass_call(x2d, op)), bits(chain())
        for _ in range(5):
            assert torch.equal(bits(kr.single_pass_call(x2d, op)), first6)
            assert torch.equal(bits(chain()), first7)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 63, 64, 127, 128, 1000, 4096, 4097,
                                    65536 + 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k6_matches_plain_at_plan_edges(cuda_device, dtype, groups):
    """One CTA; one short of, at and past MIN_GROUPS groups for one and
    for two CTAs; clusters of 8 CTAs over ragged runs of groups."""
    sub = kr.sublanes_for(dtype)
    for method in ("SUM", "MAX"):
        op = get_op(method)
        x2d = payload(groups * sub * 128, dtype, method, seed=groups
                      ).view(-1, 128)
        assert_acc_match(kr.single_pass_call(x2d.to(cuda_device), op),
                         kr.single_pass_plain(x2d, op), method, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("p, groups", [(1, 512), (2, 512), (3, 512),
                                       (16, 64), (64, 3), (132, 3),
                                       (1000, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k7_matches_plain_at_plan_edges(cuda_device, dtype, p, groups):
    """Every class of P, with spans of `groups` sub-row groups (clusters
    of 4, 2 and single CTAs), on arrays that fill the tiling and on ones
    that stop a ragged number of groups short of it, as the chain's
    partials do."""
    sub = kr.sublanes_for(dtype)
    tm, t = groups * sub, 1
    for method in ("SUM", "MIN"):
        op = get_op(method)
        for rows in (p * tm, p * tm - sub, (p * tm // 2 // sub + 1) * sub):
            x2d = payload(rows * 128, dtype, method, seed=rows
                          ).view(-1, 128)
            assert_acc_match(kr.two_pass_call(x2d.to(cuda_device), op, tm,
                                              p, t),
                             kr.two_pass_plain(x2d, op, tm, p, t), method,
                             dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [6, 7])
def test_one_shot_reduce_on_card(cuda_device, kernel):
    x = payload(1_000_003, "int32", "SUM", seed=5)
    want = int(x.numpy().sum(dtype=np.int64).astype(np.int32))
    got = kr.kernel_reduce(x, "SUM", kernel=kernel, device=cuda_device)
    assert got.device.type == "cuda" and int(got) == want


@pytest.mark.gpu
@pytest.mark.parametrize("n, threads", [
    (300_001, 64), (65536 + 5, 8), (1 << 20, 2048)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
def test_period_kernels_match_plain(cuda_device, method, dtype, n, threads):
    """k8 and k10 against the plain (TM, 128) accumulator, one launch
    each; k10 gives k8's bits (they share the split, hence the order)."""
    op = get_op(method)
    x = payload(n, dtype, method)
    tm, p, t = kr.choose_tiling(n, threads, 64, x.dtype)
    x2d = kr.stage_padded(x, tm, p, t, op, cuda_device)
    want = kr.elementwise_plain(x2d.cpu(), op, tm)
    before = (kr.elementwise_call.launches, kr.stream_call.launches)
    k8 = kr.elementwise_call(x2d, op, tm)
    k10 = kr.stream_call(x2d, op, tm)
    assert (kr.elementwise_call.launches, kr.stream_call.launches) == (
        before[0] + 1, before[1] + 1)
    assert_acc_match(k8, want, method, dtype)
    assert torch.equal(k10, k8)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_depth_is_bit_identical(cuda_device, dtype):
    """The depth moves copies, never the order of the adds: float SUM
    too gives the same bits at depths 1, 2, 4, 8 and the deepest ring."""
    op = get_op("SUM")
    x = payload(1_000_003, dtype, "SUM", seed=3)
    tm, p, t = kr.choose_tiling(x.numel(), 512, 64, x.dtype)
    x2d = kr.stage_padded(x, tm, p, t, op, cuda_device)
    first = kr.stream_call(x2d, op, tm, 1)
    for depth in (2, 4, 8, kr.stream_max_depth(x2d.dtype)):
        assert torch.equal(kr.stream_call(x2d, op, tm, depth), first), depth
    assert_acc_match(first, kr.stream_plain(x2d.cpu(), op, tm), "SUM", dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("threads", [8, 256, 2048])
@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_ragged_payloads_give_k8s_bits(cuda_device, dtype, threads):
    """Payloads that end 37 elements into a tile (identity-padded), over
    tile counts that leave some splits a half-full last stage (TM 8: 302
    tiles over 264 splits; TM 256: 78 over 8; TM 2048: 9 in one split):
    k10 at depths 1, 3 and 8 gives k8's bits, and both the plain
    accumulator."""
    tm = kr.choose_tiling(1, threads, 1, dtype)[0]
    tiles = {8: 302, 16: 302, 256: 78, 2048: 9}[tm]
    n = (tiles - 1) * tm * 128 + 37
    for method in ("SUM", "MAX"):
        op = get_op(method)
        x = payload(n, dtype, method, seed=threads)
        tm_, p, t = kr.choose_tiling(n, threads, 1000, x.dtype)
        assert (tm_, p * t) == (tm, tiles)
        x2d = kr.stage_padded(x, tm, p, t, op, cuda_device)
        k8 = kr.elementwise_call(x2d, op, tm)
        for depth in (1, 3, 8):
            assert torch.equal(bits(kr.stream_call(x2d, op, tm, depth)),
                               bits(k8)), depth
        assert_acc_match(k8, kr.elementwise_plain(x2d.cpu(), op, tm),
                         method, dtype)


# k8's three forms (csrc/accumulate.cu K8), each on an identity-padded,
# ragged payload: (n, --threads) giving one split (one tile), splits that
# the last CTA of each slot group folds (TM 256: 8, or 16 for bf16), and
# more splits than K8_MAX_FUSED_SPLITS (TM 8, or 16 for bf16: a second
# launch folds them)
K8_FORMS = {"one split": (2048 * 128 - 37, 2048),
            "fused": ((1 << 22) + 37, 256),
            "two launches": (65536 * 8 + 5, 8)}


def _k8_staged(cuda_device, method, dtype, form, seed=0):
    """(op, x2d, tm, plan) of one of K8_FORMS, the plan checked to be of
    that form."""
    op = get_op(method)
    n, threads = K8_FORMS[form]
    x = payload(n, dtype, method, seed=seed)
    tm, p, t = kr.choose_tiling(n, threads, 64, x.dtype)
    x2d = kr.stage_padded(x, tm, p, t, op, cuda_device)
    plan = kr.plan_k8(x2d.shape[0] // tm, tm, kr.sublanes_for(x2d.dtype),
                      kr._sm_count(x2d.device))
    assert {"one split": plan.splits == 1,
            "fused": 1 < plan.splits and plan.fused,
            "two launches": not plan.fused}[form], plan
    return op, x2d, tm, plan


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(K8_FORMS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
def test_k8_matches_plain_in_every_form(cuda_device, method, dtype, form):
    """k8 against the plain (TM, 128) accumulator in each of its forms,
    one counted launch a call; k10 at depths 1, 4 and the deepest ring
    gives k8's bits (the same splits, so the same order of adds)."""
    op, x2d, tm, _ = _k8_staged(cuda_device, method, dtype, form)
    before = kr.elementwise_call.launches
    k8 = kr.elementwise_call(x2d, op, tm)
    assert kr.elementwise_call.launches == before + 1
    assert_acc_match(k8, kr.elementwise_plain(x2d.cpu(), op, tm), method,
                     dtype)
    for depth in (1, 4, kr.stream_max_depth(x2d.dtype)):
        assert torch.equal(bits(kr.stream_call(x2d, op, tm, depth)),
                           bits(k8)), depth


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["fused", "two launches"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k8_same_bits_back_to_back_and_on_two_streams(cuda_device, dtype,
                                                      form):
    """Each launch leaves its stream's tickets at zero, and each stream
    has its own: 16 calls queued back to back on one stream, and 8 on
    each of two streams at once, give the first call's bits, float SUM
    included."""
    op, x2d, tm, _ = _k8_staged(cuda_device, "SUM", dtype, form, seed=7)
    want = bits(kr.elementwise_call(x2d, op, tm)).clone()
    queued = [kr.elementwise_call(x2d, op, tm) for _ in range(16)]
    streams = (torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device))
    on_streams = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    for _ in range(8):
        for s in streams:
            with torch.cuda.stream(s):
                on_streams.append(kr.elementwise_call(x2d, op, tm))
    torch.cuda.synchronize()
    for got in queued + on_streams:
        assert torch.equal(bits(got), want)


@pytest.mark.gpu
@pytest.mark.parametrize("threads, cuda_launches", [(256, 1), (8, 2)])
def test_k8_cuda_launches_per_call(cuda_device, threads, cuda_launches):
    """torch.profiler sees one CUDA launch a call at the main path's
    shape (int32 SUM n = 2^24, TM 256: 8 splits folded in the pass), and
    two at TM 8 (264 splits, folded by a second launch)."""
    from tpu_reductions_torch.bench.passes import kernel_profile
    op = get_op("SUM")
    n = 1 << 24
    tm, p, t = kr.choose_tiling(n, threads, 64, "int32")
    x2d = kr.stage_padded(payload(n, "int32", "SUM"), tm, p, t, op,
                          cuda_device)
    prof = kernel_profile(lambda: kr.elementwise_call(x2d, op, tm), calls=4)
    assert len(prof["launch_us"]) == cuda_launches


@pytest.mark.gpu
def test_k8_refuses_a_misaligned_base(cuda_device):
    """The 16-byte loads need a 16-byte aligned base."""
    x2d = torch.zeros((64, 128), dtype=torch.int32, device=cuda_device)
    skewed = x2d.view(-1)[1:1 + 56 * 128].view(56, 128)
    with pytest.raises(ValueError, match="16-byte"):
        kr.elementwise_call(skewed, get_op("SUM"), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_k9_k10_repeat_their_bits(cuda_device, dtype):
    """No float atomics, and an order fixed by the shape: k10 (depths 1
    and 4) and k9 (float dtypes) give the same bits on every call on the
    same staged tensor, float SUM included."""
    op = get_op("SUM")
    n = (1 << 22) + 37
    x = payload(n, dtype, "SUM", seed=9)
    tm, p, t = kr.choose_tiling(n, 256, 64, x.dtype)
    x2d = kr.stage_padded(x, tm, p, t, op, cuda_device)
    calls = {f"k10 depth {d}": (lambda d=d: kr.stream_call(x2d, op, tm, d))
             for d in (1, 4)}
    if dtype != "int32":
        calls["k9"] = lambda: kr.mxu_call(x2d, op)
    for name, call in calls.items():
        first = bits(call())
        for _ in range(5):
            assert torch.equal(bits(call()), first), name


@pytest.mark.gpu
@pytest.mark.parametrize("slabs", [1, 3, 7, 2113, 16391])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_mxu_runs_that_do_not_divide(cuda_device, dtype, slabs):
    """Slab counts that the warps' equal runs do not divide (a last run
    shorter than the others), and payloads smaller than one run of the
    main path (8 slabs): row 0 the column sums, rows 1-7 zero. A float64
    slab is 4 rows and the staged rows are a multiple of 8, so its counts
    are twice these."""
    rows = {"float32": 8, "float64": 8, "bfloat16": 16}[dtype] * slabs
    x2d = payload(rows * 128, dtype, "SUM", seed=slabs).view(rows, 128)
    got = kr.mxu_call(x2d.to(cuda_device), get_op("SUM")).cpu()
    want = kr.mxu_plain(x2d)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got[1:], torch.zeros_like(got[1:]))
    np.testing.assert_allclose(got[0].double().numpy(),
                               want[0].double().numpy(),
                               rtol=SUM_RTOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 300_001, 1 << 22])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_mxu_matches_plain(cuda_device, dtype, n):
    """k9: rows 1-7 exactly zero, row 0 the column sums within rtol."""
    op = get_op("SUM")
    x = payload(n, dtype, "SUM", seed=n)
    tm, p, t = kr.choose_tiling(n, 256, 64, x.dtype)
    x2d = kr.stage_padded(x, tm, p, t, op, cuda_device)
    before = kr.mxu_call.launches
    got = kr.mxu_call(x2d, op).cpu()
    assert kr.mxu_call.launches == before + 1
    want = kr.mxu_plain(x2d.cpu())
    assert got.shape == want.shape == (8, 128) and got.dtype == want.dtype
    assert torch.equal(got[1:], torch.zeros_like(got[1:]))
    np.testing.assert_allclose(got[0].double().numpy(),
                               want[0].double().numpy(),
                               rtol=SUM_RTOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_mxu_column_layout_is_exact(cuda_device, dtype):
    """Small integers sum exactly in any order: row 0 must equal the
    column sums bit for bit, which pins the fragment layouts (every
    column lands where it belongs)."""
    rows = torch.arange(64).reshape(-1, 1)
    cols = torch.arange(128).reshape(1, -1)
    x2d = ((cols % 16) + 16 * (rows % 4)).to(getattr(torch, dtype))
    got = kr.mxu_call(x2d.to(cuda_device).contiguous(),
                      get_op("SUM")).cpu()
    assert torch.equal(got, kr.mxu_plain(x2d))


@pytest.mark.gpu
def test_mxu_float32_keeps_all_24_bits(cuda_device):
    """1 + 2^-22 is not a TF32 value: plain TF32 would sum one slab of it
    to exactly 8; the three-piece split gives 8 + 2^-19 exactly."""
    x2d = torch.full((8, 128), 1 + 2.0**-22, dtype=torch.float32)
    got = kr.mxu_call(x2d.to(cuda_device), get_op("SUM")).cpu()
    assert torch.equal(got[0], torch.full((128,), 8 + 2.0**-19))


@pytest.mark.gpu
def test_new_kernels_refuse_what_they_cannot_take(cuda_device):
    x2d = torch.zeros((64, 128), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="float dtype"):
        kr.mxu_call(x2d.to(torch.int32), get_op("SUM"))
    with pytest.raises(ValueError, match="SUM only"):
        kr.mxu_call(x2d, get_op("MIN"))
    with pytest.raises(ValueError, match="rows % tm"):
        kr.stream_call(x2d[:56], get_op("SUM"), 16)
    with pytest.raises(ValueError, match="rows % tm"):
        kr.elementwise_call(x2d[:56], get_op("SUM"), 16)
    deepest = kr.stream_max_depth(torch.float32)
    with pytest.raises(ValueError, match=f"at most {deepest} stages"):
        kr.stream_call(x2d, get_op("SUM"), 8, deepest + 1)
    with pytest.raises(ValueError, match="16-byte"):
        kr.mxu_call(x2d.view(-1)[1:1 + 56 * 128].view(56, 128),
                    get_op("SUM"))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [8, 9, 10])
def test_one_shot_reduce_new_kernels(cuda_device, kernel):
    """A float32 sum of 10^6 values in [0, 1) is about 5e5, where one f32
    ulp is 0.03: held to rtol 1e-6 (the benchmark's 1e-8 n is written for
    its own payload of tiny values)."""
    x = payload(1_000_003, "float32", "SUM", seed=6)
    want = float(x.double().sum())
    got = kr.kernel_reduce(x, "SUM", kernel=kernel, stream_buffers=3,
                           device=cuda_device)
    assert got.device.type == "cuda"
    assert abs(float(got) - want) <= SUM_RTOL["float32"] * want


# --- the f64 pair route (dd) and the streaming pipeline ---------------------

PAIR_UNIT = 2.0**-24      # float32's unit roundoff; a pair's is 4u^2


def assert_pair_match(got, want, planes, method, tm):
    """dd against dd_plain. MIN/MAX select and must be bit-equal. SUM adds
    in another grouping once the tiles are split: each slot's hi + lo must
    be within 2 (d - 1) 4u^2 sum|x| of dd_plain's, d the tiles folded into
    the slot and sum|x| over the slot's elements (csrc/pair.cu)."""
    got = tuple(g.cpu() for g in got)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (tm, 128) and g.dtype == w.dtype
    if method != "SUM":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    hi, lo = (p.cpu().double() for p in planes)
    d = hi.shape[0] // tm
    mag = (hi + lo).abs().reshape(d, tm, 128).sum(0)
    err = ((got[0].double() + got[1].double())
           - (want[0].double() + want[1].double())).abs()
    assert bool((err <= 2 * (d - 1) * 4 * PAIR_UNIT**2 * mag).all()), \
        float(err.max())


def f64_payload(n, method, seed=0, scale=1.0) -> np.ndarray:
    """Non-negative for SUM (the benchmark payload's sign), signed for
    MIN/MAX; `scale` spreads it over the f64 range."""
    rng = np.random.default_rng(seed)
    x = rng.random(n) if method == "SUM" else rng.standard_normal(n)
    return x * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n, threads", [
    (300_001, 8), ((1 << 20) + 37, 256), (1 << 22, 2048)])
@pytest.mark.parametrize("method", METHODS)
def test_dd_matches_plain(cuda_device, method, n, threads):
    """The pair kernel against dd_plain at TM 8, 256 and 2048, ragged n
    included; one launch each."""
    from tpu_reductions_torch.ops import dd_reduce as dd
    x = f64_payload(n, method, seed=n)
    hi, lo, (tm, _, _), _ = dd.stage_split_padded(x, method, threads, 64)
    planes = (torch.from_numpy(hi).to(cuda_device),
              torch.from_numpy(lo).to(cuda_device))
    before = dd.dd_call.launches
    got = dd.dd_call(*planes, method, tm)
    assert dd.dd_call.launches == before + 1
    assert_pair_match(got, dd.dd_plain(torch.from_numpy(hi),
                                       torch.from_numpy(lo), method, tm),
                      planes, method, tm)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("method", METHODS)
def test_dd_full_range_on_card(cuda_device, method):
    """uniform(-1, 1) x 1e300: SUM within 1e-12 max(|exact|, max|x|) of
    math.fsum (tests/test_dd_reduce.py's rule), MIN/MAX exact, through the
    route's core, one launch with the pair finish fused; the accumulator
    holds to the plain version's rule."""
    import math

    from tpu_reductions_torch.ops import dd_reduce as dd
    n = (1 << 20) + 37
    x = np.random.default_rng(7).uniform(-1, 1, n) * 1e300
    stage_fn, core, finish = dd.make_dd_device_reduce(method, n,
                                                      device=cuda_device)
    hi2d, lo2d, s = stage_fn(x)
    before = dd.dd_call.launches
    got = float(finish(*core(hi2d, lo2d), scale_exp=s))
    assert dd.dd_call.launches == before + 1   # the fused finish
    if method == "SUM":
        exact = math.fsum(x.tolist())
        assert abs(got - exact) <= 1e-12 * max(abs(exact),
                                               float(np.abs(x).max()))
    else:
        assert got == (x.min() if method == "MIN" else x.max())
    assert_pair_match(dd.dd_call(hi2d, lo2d, method, 256),
                      dd.dd_plain(hi2d.cpu(), lo2d.cpu(), method, 256),
                      (hi2d, lo2d), method, 256)


@pytest.mark.gpu
def test_dd_refuses_what_it_cannot_take(cuda_device):
    from tpu_reductions_torch.ops import dd_reduce as dd
    f = torch.zeros((64, 128), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="float32 planes"):
        dd.dd_call(f.int(), f.int(), "SUM", 8)
    with pytest.raises(ValueError, match="rows % tm"):
        dd.dd_call(f[:56], f[:56], "SUM", 16)
    with pytest.raises(ValueError, match="planes differ"):
        dd.dd_call(f, f[:56], "SUM", 8)
    off = f.view(-1)[1:1 + 56 * 128].view(56, 128)
    with pytest.raises(ValueError, match="16-byte"):
        dd.dd_scalar_call(off, off, "SUM", 8)


def _dd_planes(dev, method, n, threads, seed=0):
    from tpu_reductions_torch.ops import dd_reduce as dd
    x = f64_payload(n, method, seed=seed)
    hi, lo, (tm, _, _), _ = dd.stage_split_padded(x, method, threads, 64)
    return (torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)), tm


def _pair_bits(pair) -> list:
    return [bits(p.reshape(-1)).cpu().tolist() for p in pair]


@pytest.mark.gpu
@pytest.mark.parametrize("n, threads", [
    (300_001, 8), ((1 << 20) + 37, 256), (1 << 22, 2048),
    ((1 << 20) + 37, 200)])
@pytest.mark.parametrize("method", METHODS)
def test_dd_scalar_is_the_tree_of_its_accumulator(cuda_device, method, n,
                                                   threads):
    """The fused finish: one launch writes the accumulator and the scalar
    pair, and the pair is device_finish_pairs (the torch tree, on the
    card) of that same accumulator bit for bit, at TM 8, 256, 2048 and
    200 (padded to a power of two), ragged n; the accumulator is
    dd_call's and holds to the plain version's rule."""
    from tpu_reductions_torch.ops import dd_reduce as dd
    planes, tm = _dd_planes(cuda_device, method, n, threads, seed=n)
    size = tm * 128
    before = dd.dd_call.launches
    out = dd._launch(*planes, method, tm, scalar=True)
    scalar = dd.dd_scalar_call(*planes, method, tm)
    acc = dd.dd_call(*planes, method, tm)
    assert dd.dd_call.launches == before + 3
    fused_acc = (out[:size].view(tm, 128), out[size:2 * size].view(tm, 128))
    assert _pair_bits(fused_acc) == _pair_bits(acc)
    tree = dd.device_finish_pairs(*fused_acc, method)
    assert _pair_bits(scalar) == _pair_bits(tree)
    assert _pair_bits((out[2 * size], out[2 * size + 1])) == _pair_bits(tree)
    assert scalar[0].shape == () and scalar[0].device == planes[0].device
    assert_pair_match(acc, dd.dd_plain(planes[0].cpu(), planes[1].cpu(),
                                       method, tm), planes, method, tm)


@pytest.mark.gpu
@pytest.mark.parametrize("method", METHODS)
def test_dd_scalar_same_bits_back_to_back_and_on_two_streams(cuda_device,
                                                             method):
    """The ticket of the last CTA is the call's own: 16 calls queued back
    to back on one stream, and 8 on each of two streams at once, give the
    first call's bits."""
    from tpu_reductions_torch.ops import dd_reduce as dd
    planes, tm = _dd_planes(cuda_device, method, (1 << 21) + 5, 256, seed=3)
    want = _pair_bits(dd.dd_scalar_call(*planes, method, tm))
    queued = [dd.dd_scalar_call(*planes, method, tm) for _ in range(16)]
    streams = (torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device))
    on_streams = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    for _ in range(8):
        for s in streams:
            with torch.cuda.stream(s):
                on_streams.append(dd.dd_scalar_call(*planes, method, tm))
    torch.cuda.synchronize()
    for got in queued + on_streams:
        assert _pair_bits(got) == want


@pytest.mark.gpu
@pytest.mark.parametrize("threads", [8, 200, 256, 2048])
@pytest.mark.parametrize("method", METHODS)
def test_dd_scalar_same_bits_at_every_geometry(cuda_device, method,
                                               threads):
    """Every number of pass-2 threads gives the planned launch's scalar
    bits (the tree's order does not depend on it), and every number of
    splits does for MIN/MAX."""
    from tpu_reductions_torch.ops import _cuda
    from tpu_reductions_torch.ops import dd_reduce as dd
    planes, tm = _dd_planes(cuda_device, method, (1 << 20) + 37, threads)
    tiles = planes[0].shape[0] // tm
    planned = dd.plan_dd(tiles, tm, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    want = _pair_bits(dd.dd_scalar_call(*planes, method, tm))
    size = tm * 128
    padded = dd._pow2_ceil(size)
    plans = [dd.DdPlan(planned.splits, r) for r in (256, 1024, 2048, 8192)
             if padded // dd.DD_MAX_LEAVES <= r <= padded]
    if method != "SUM":
        plans += [dd.DdPlan(s, planned.residues)
                  for s in (1, 3, min(tiles, dd.DD_MAX_SPLITS))]
    for plan in plans:
        out = torch.empty(dd._out_words(tm, plan), dtype=planes[0].dtype,
                          device=cuda_device)
        _cuda.dd_reduce(*planes, out, dd._tickets(cuda_device), tm, plan,
                        method, True)
        assert _pair_bits((out[2 * size], out[2 * size + 1])) == want, plan


@pytest.mark.gpu
@pytest.mark.parametrize("method, dtype", [
    ("SUM", "int32"), ("SUM", "float64"), ("MIN", "float64"),
    ("MAX", "bfloat16"), ("SUM", "float32")])
def test_stream_pipelined_equals_serial_on_card(cuda_device, method, dtype):
    """The double-buffered stream gives the serial comparator's value bit
    for bit (same chunks, same folds), and passes the oracle."""
    from tpu_reductions_torch.bench.stream import run_serial_baseline
    from tpu_reductions_torch.ops.oracle import host_reduce, verify
    from tpu_reductions_torch.ops.stream import run_stream
    from tpu_reductions_torch.utils.rng import host_data
    n = (1 << 22) + 5
    x = host_data(n, dtype, seed=4)
    res = run_stream(x, method, chunk_bytes=1 << 20, sync_every=3,
                     device=cuda_device)
    assert res.num_chunks > 4
    serial = run_serial_baseline(x, method, chunk_bytes=1 << 20,
                                 device=cuda_device)
    assert float(np.asarray(res.value, np.float64)) == serial["value"]
    ok, diff = verify(res.value, host_reduce(x, method), method, dtype, n)
    assert ok, diff


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_stage_on_card_is_bit_identical(cuda_device, monkeypatch,
                                                dtype):
    """Staging through pinned slots in chunks gives the one-shot stage's
    bits on the card, a ragged tail included, at every depth."""
    from tpu_reductions_torch.utils.staging import (device_put_chunked,
                                                    maybe_chunked_stage)
    x = payload((1 << 20) + 37, dtype, "MIN")
    op = get_op("MIN")
    tm, p, t = kr.choose_tiling(x.numel(), 256, 64, dtype)
    want = kr.stage_padded(x, tm, p, t, op, cuda_device)
    monkeypatch.setenv("TPU_REDUCTIONS_STAGE_THRESHOLD_BYTES", "1")
    for chunk in (4096, 1 << 16, 3 << 20):
        monkeypatch.setenv("TPU_REDUCTIONS_STAGE_CHUNK_BYTES", str(chunk))
        got = maybe_chunked_stage(x, *want.shape, op.identity(x.dtype),
                                  cuda_device)
        assert got.device.type == "cuda"
        assert torch.equal(bits(got), bits(want))
        for slots in (1, 3):
            got = device_put_chunked(x, *want.shape, op.identity(x.dtype),
                                     cuda_device, slots=slots)
            assert torch.equal(bits(got), bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel, method, dtype, f64", [
    (6, "SUM", "int32", "native"), (7, "MAX", "float32", "native"),
    (8, "SUM", "float64", "native"), (9, "SUM", "float32", "native"),
    (10, "MIN", "int32", "native"), (6, "SUM", "float64", "dd")])
def test_consistency_check_on_card(cuda_device, kernel, method, dtype, f64):
    from tpu_reductions_torch.utils.debug import consistency_check
    rep = consistency_check(method, dtype, 1 << 20, kernel=kernel, f64=f64)
    assert rep.ok, rep.describe()


@pytest.mark.gpu
def test_trace_names_the_kernel_launches(cuda_device, tmp_path):
    import json

    from tpu_reductions_torch.utils.debug import TRACE_FILE, trace_benchmark
    op = get_op("SUM")
    x2d = kr.stage_padded(payload(1 << 20, "int32", "SUM"),
                          *kr.choose_tiling(1 << 20), op, cuda_device)
    _, device_events, launches = trace_benchmark(
        lambda t: kr.single_pass_call(t, op), x2d, trace_dir=str(tmp_path),
        device=cuda_device)
    assert device_events >= 3 and launches >= 3
    names = [e.get("name", "") for e in json.loads(
        (tmp_path / TRACE_FILE).read_text())["traceEvents"]]
    assert sum("fold_span" in name for name in names) >= 3


@pytest.mark.gpu
def test_native_oracle_on_the_card_host(cuda_device):
    from tpu_reductions_torch.ops import oracle
    assert oracle.native_available()


def _eager_chain(core, op, planes, k):
    """The chain's plain loop on the card: the bits the graph must give."""
    from tpu_reductions_torch.ops.chain import fold_into
    planes = tuple(p.clone() for p in planes)
    last = None
    for _ in range(k):
        last = core(*planes)
        last = last[0] if isinstance(last, tuple) else last
        fold_into(planes[0], last, op)
    return last


def _chain_case(name, device):
    """(core, op, planes, counted wrapper) of a chained int32/f64 SUM at a
    ragged n through k6, k8 or the pair route."""
    from tpu_reductions_torch.ops import dd_reduce as dd
    n = (1 << 20) + 37
    if name == "dd":
        stage, core, _ = dd.make_dd_device_reduce("SUM", n, device=device)
        hi2d, lo2d, _ = stage(payload(n, "float64", "SUM").numpy())
        return core, get_op("SUM"), (hi2d, lo2d), dd.dd_call
    kernel = {"k6": 6, "k8": 8}[name]
    op, stage_fn, core = kr.make_staged_core("SUM", n, "int32",
                                             kernel=kernel, device=device)
    wrapper = kr.single_pass_call if kernel == 6 else kr.elementwise_call
    return core, op, (stage_fn(payload(n, "int32", "SUM")),), wrapper


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 17])
@pytest.mark.parametrize("name", ["k6", "k8", "dd"])
def test_graph_chain_gives_the_eager_chains_bits(cuda_device, name, k):
    """On the card a chain is one CUDA graph a trip: its scalar has the
    plain loop's bits, the staged tensors stay as staged, and the
    counter reads the warm-up step's launch, then the captured launches
    (one an iteration) times the replays."""
    from tpu_reductions_torch.ops.chain import make_chained_reduce
    core, op, planes, wrapper = _chain_case(name, cuda_device)
    before = tuple(p.clone() for p in planes)
    want = _eager_chain(core, op, planes, k)
    chained = make_chained_reduce(core, op)
    arg = planes if len(planes) > 1 else planes[0]
    start = wrapper.launches
    got = [chained(arg, k) for _ in range(2)]
    torch.cuda.synchronize()
    assert wrapper.launches - start == 1 + 2 * k
    for g in got:
        assert torch.equal(bits(g), bits(want))
    assert all(torch.equal(p, b) for p, b in zip(planes, before))
    chained.close()


@pytest.mark.gpu
def test_chained_row_trace_names_the_graphs_kernels(cuda_device, tmp_path):
    """--trace of a chained row traces its chain's graph replays, and the
    trace names k6's launches inside the graph."""
    import io
    import json

    from tpu_reductions_torch.bench import driver
    from tpu_reductions_torch.config import ReduceConfig
    from tpu_reductions_torch.utils.debug import TRACE_FILE
    from tpu_reductions_torch.utils.logging import BenchLogger
    res = driver.run_benchmark(
        ReduceConfig(method="SUM", dtype="int32", n=1 << 22,
                     timing="chained", iterations=16, chain_reps=2,
                     trace_dir=str(tmp_path), log_file=None),
        logger=BenchLogger(console=io.StringIO()))
    assert res.passed
    names = [e.get("name", "") for e in json.loads(
        (tmp_path / TRACE_FILE).read_text())["traceEvents"]]
    assert sum("fold_span" in name for name in names) >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("method, dtype, impl", [
    ("SCAN", "int32", "xla-cumsum"), ("SCAN", "float32", "xla-cumsum"),
    ("SCAN", "float32", "mxu-scan"), ("SEGSUM", "int32", "seg"),
    ("SEGMIN", "float32", "seg"), ("SEGMAX", "int32", "seg"),
    ("ARGMIN", "float32", "argk"), ("ARGMAX", "int32", "argk")])
def test_family_cells_verify_on_card(cuda_device, method, dtype, impl):
    """Each family cell verifies against the host oracle on the card, and
    its chained digest through the graph gives the plain loop's value."""
    from tpu_reductions_torch.bench.family_spot import (_cell_fns, _verify,
                                                        measure_cell)
    from tpu_reductions_torch.ops.chain import make_chained_reduce
    from tpu_reductions_torch.ops.oracle import host_value
    from tpu_reductions_torch.utils.rng import host_data
    n = 1 << 20
    x_host = host_data(n, dtype)
    x = x_host.to(cuda_device)
    full, core, offsets = _cell_fns(method, dtype, impl, x, 64, 0)
    ok, err = _verify(method, dtype, x_host.numpy(), host_value(full(x)),
                      offsets)
    assert ok, err
    op = get_op(method)
    want = _eager_chain(core, op, (x.reshape(-1, 128),), 5)
    got = make_chained_reduce(core, op)(x.reshape(-1, 128), 5)
    if dtype == "float32" and method in ("SCAN", "SEGSUM"):
        # atomics and blocked products add in an order of their own
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    else:
        assert torch.equal(got.cpu(), want.cpu())
    row = measure_cell(method, dtype, impl, n, 64, 0, 2, cuda_device)
    assert row["status"] == "PASSED" and row["gbps"] > 0


# ---------------------------------------------------------------------------
# the collectives on the card: the rank axis as rows of one CUDA tensor
# ---------------------------------------------------------------------------

def _collective_case(device, k, per, dtype, seed=0):
    """The mesh of k ranks on `device` and on the CPU, and one payload."""
    from tpu_reductions_torch.bench.collective_driver import _build_payload
    from tpu_reductions_torch.config import CollectiveConfig
    from tpu_reductions_torch.parallel.mesh import build_mesh
    platform = "gpu" if device.type == "cuda" else "cpu"
    mesh = build_mesh(num_devices=k, platform=platform, local_ranks=k,
                      device=device)
    x = _build_payload(CollectiveConfig(dtype=dtype, n=k * per, seed=seed),
                       k)
    return mesh, x


@pytest.mark.gpu
@pytest.mark.parametrize("rooted", ["none", "scatter", "root"])
@pytest.mark.parametrize("k, per", [(1, 4096), (6, 6000), (8, 4096),
                                    (8, 4100), (64, 1024)])
@pytest.mark.parametrize("dtype, method", [
    ("int32", "SUM"), ("int32", "MIN"), ("int32", "MAX"),
    ("float32", "MIN"), ("float64", "MAX"), ("bfloat16", "MIN")])
def test_collective_on_card_gives_the_cpu_bits(cuda_device, rooted, k, per,
                                               dtype, method):
    """int32 and MIN/MAX collectives are exact: the card gives the CPU
    run's bits on every rank row, and a reduce-to-root's rows are all the
    same."""
    from tpu_reductions_torch import collectives as coll
    results = []
    for device in (cuda_device, torch.device("cpu")):
        mesh, x = _collective_case(device, k, per, dtype)
        fn = coll.make_collective_reduce(method, mesh, rooted=rooted)
        results.append(fn(coll.shard_payload(x, mesh)).cpu())
    got, want = results
    assert torch.equal(bits(got), bits(want))
    if rooted != "scatter":
        assert all(torch.equal(bits(row), bits(got[0])) for row in got)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
@pytest.mark.parametrize("k, per", [(3, 1000), (8, 4096), (8, 4100)])
def test_pair_collectives_on_card_give_the_cpu_planes(cuda_device, method,
                                                      k, per):
    """The dd ring (and its naive fallback) and the key-pair MIN/MAX: the
    card's hi/lo planes are the CPU run's bits on every rank row."""
    from tpu_reductions_torch import collectives as coll
    from tpu_reductions_torch.ops.dd_reduce import (host_key_encode,
                                                    host_split_scaled)
    results = []
    for device in (cuda_device, torch.device("cpu")):
        mesh, x = _collective_case(device, k, per, "float64", seed=1)
        if method == "SUM":
            hi, lo, _ = host_split_scaled(x.numpy())
            fn = coll.make_dd_sum_all_reduce(mesh)
        else:
            hi, lo = host_key_encode(x.numpy())
            fn = coll.make_key_minmax_all_reduce(method, mesh)
        out = fn(coll.shard_payload(hi, mesh), coll.shard_payload(lo, mesh))
        results.append(tuple(o.cpu() for o in out))
    for got, want in zip(*results):
        assert torch.equal(bits(got), bits(want))
        assert all(torch.equal(bits(row), bits(got[0])) for row in got)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 17])
@pytest.mark.parametrize("case", ["SUM-none", "MIN-scatter", "SUM-root",
                                  "dd-SUM", "key-MAX"])
def test_collective_graph_chain_gives_the_eager_chains_scalar(cuda_device,
                                                              case, k):
    """A chained collective on the card is one CUDA graph a trip: its
    scalar is the eager loop's (the CPU chain's) for every path."""
    from tpu_reductions_torch import collectives as coll
    from tpu_reductions_torch.ops.dd_reduce import (host_key_encode,
                                                    host_split_scaled)
    kind, arg = case.split("-")
    got = []
    for device in (cuda_device, torch.device("cpu")):
        mesh, x = _collective_case(device, 8, 4096, (
            "float64" if kind in ("dd", "key") else "int32"))
        if kind == "dd":
            hi, lo, _ = host_split_scaled(x.numpy())
            planes = (coll.shard_payload(hi, mesh),
                      coll.shard_payload(lo, mesh))
            chained = coll.make_chained_pair_collective(
                "SUM", coll.make_dd_sum_all_reduce(mesh))
        elif kind == "key":
            hi, lo = host_key_encode(x.numpy())
            planes = (coll.shard_payload(hi, mesh),
                      coll.shard_payload(lo, mesh))
            chained = coll.make_chained_pair_collective(
                arg, coll.make_key_minmax_all_reduce(arg, mesh))
        else:
            planes = coll.shard_payload(x, mesh)
            chained = coll.make_chained_collective(kind, mesh, rooted=arg)
        before = planes[0].clone() if kind in ("dd", "key") else \
            planes.clone()
        got.append([chained(planes, k).cpu() for _ in range(2)])
        first = planes[0] if kind in ("dd", "key") else planes
        assert torch.equal(first, before)     # the chain folds into a copy
        chained.close()
    card, cpu = got
    for g in card:
        assert torch.equal(bits(g), bits(cpu[0]))


@pytest.mark.gpu
def test_collective_cli_on_card_refuses_two_processes(cuda_device):
    """On the card more processes than the host's cards exit 1 with their
    reason (each process drives a card of its own: two on one card is
    NCCL's duplicate GPU failure); never moved to the CPU."""
    import subprocess
    import sys
    nproc = torch.cuda.device_count() + 1
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_reductions_torch.bench.collective_driver",
         "--method=SUM", "--n=4096", f"--devices={nproc}",
         f"--num-processes={nproc}", "--process-id=0",
         "--coordinator=127.0.0.1:1"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert (f"{nproc} processes on this host but "
            f"{nproc - 1} card(s)") in proc.stderr
    assert "DATATYPE" not in proc.stdout


@pytest.mark.gpu
def test_collective_cli_on_card_passes(cuda_device):
    """The CLI on the card: its note names the card, every row PASSED."""
    import contextlib
    import io
    from tpu_reductions_torch.bench import collective_driver
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = collective_driver.main(["--method=MIN", "--type=double",
                                     "--n=65536", "--devices=8",
                                     "--rooted=root", "--retries=2"])
    assert rc == 0
    assert f"rows of one tensor on {torch.cuda.get_device_name()}" in \
        out.getvalue()
    assert "&&&& tpu_reductions_torch.collective PASSED" in out.getvalue()


# ---------------------------------------------------------------------------
# the rank axis across cards (bench/multicard.py): two processes, one a
# card, NCCL between them, against one card's bits
# ---------------------------------------------------------------------------

MULTICARD_ROWS = (
    ["--method=SUM", "--type=int", "--n=4194304", "--devices=4",
     "--retries=2"],
    ["--method=SUM", "--type=int", "--n=4194304", "--devices=4",
     "--retries=2", "--timing=chained"],
    ["--method=SUM", "--type=double", "--f64=dd", "--n=4194304",
     "--devices=4", "--retries=2", "--timing=chained", "--chainspan=4"],
    ["--method=MIN", "--type=int", "--n=4194304", "--devices=4",
     "--rooted=scatter", "--retries=2", "--timing=chained",
     "--chainspan=4"],
)


@pytest.fixture(scope="module")
def two_cards(tmp_path_factory):
    """The MULTICARD_ROWS in two processes on cards 0 and 1."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs: run `python -m pytest "
                    "-q -m gpu --noconftest tests/test_torch_cuda.py -k "
                    "multicard` on a machine with several cards")
    from tpu_reductions_torch.bench import multicard
    return multicard.launch([list(r) for r in MULTICARD_ROWS], 2,
                            tmp_path_factory.mktemp("multicard"),
                            timeout_s=300)


@pytest.fixture(scope="module")
def one_card_twins(two_cards):
    """The MULTICARD_ROWS in this process on one card."""
    from tpu_reductions_torch.bench import multicard
    return list(multicard.twins([list(r) for r in MULTICARD_ROWS]))


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(MULTICARD_ROWS)),
                         ids=["all_reduce", "all_reduce_chained", "dd_ring",
                              "rooted_scatter"])
def test_multicard_rows_give_the_one_card_bits(two_cards, one_card_twins,
                                               i):
    """An all-reduce (periter, and chained over the same payload), the dd
    ring and a rooted scatter (the MIN/MAX butterfly) across two cards
    over NCCL: every row PASSED in both processes, with one card's bits;
    on a chained row each process's captured chain, NCCL inside the
    graph, gives the scalar of the same chain run one by one (else the
    row FAILED in collective_driver) and process 0's is one card's."""
    from tpu_reductions_torch.bench import multicard
    assert two_cards["rcs"] == [0, 0] and two_cards["survivors"] == []
    recs = [r[i] for r in two_cards["records"]]
    twin = one_card_twins[i]
    for rec in recs:
        assert {r["status"] for r in rec["results"]} == {"PASSED"}
    assert multicard.same_bits(twin["views"], recs)
    assert {r["status"] for r in twin["results"]} == {"PASSED"}
    assert "lie on 2 cards" in recs[0]["log"]
    if "--timing=chained" in MULTICARD_ROWS[i]:
        for j, rec in enumerate(recs):
            if j == 0 or rec["replicated"]:
                assert multicard.chain_agrees(
                    multicard.chain_scalar(rec), twin["chain"], True,
                    "SUM", "int32", 4194304)
    else:
        assert twin["chain"] is None and recs[0]["chain"] is None


@pytest.mark.gpu
def test_multicard_int32_sum_wraps_as_the_oracle(two_cards):
    """NCCL's int32 SUM across two cards, at a payload whose every sum
    overflows int32, against the host oracle (wrapping mod 2^32)."""
    import sys
    from pathlib import Path
    from tpu_reductions_torch.bench import multicard
    code = (Path(__file__).resolve().parent
            / "multicard_overflow.py").read_text()
    port = multicard.free_port()
    group = multicard.run_group(
        [[sys.executable, "-c", code, "gpu", str(port), str(i)]
         for i in range(2)], 180)
    for rc, (out, err) in zip(group["rcs"], group["outs"]):
        assert rc == 0, err
        assert out.startswith("wrapped ")
    assert group["survivors"] == []


# ---------------------------------------------------------------------------
# the quantized wire and reshard on the card (collectives/quant.py,
# reshard/): the card gives the CPU's bits
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("bits_", [4, 8, 16])
def test_block_encode_on_card_gives_the_cpu_bits(cuda_device, bits_):
    """Carriers and scales of the card's encode equal the CPU's, and so
    does the exact float64 decode."""
    from tpu_reductions_torch.collectives import quant
    x = payload(8 * 4096, "float32", "MIN", seed=bits_).view(8, -1)
    x[0, :256] = 0.0                              # a zero block: scale 1
    card = quant.block_encode(x.to(cuda_device), bits_)
    cpu = quant.block_encode(x, bits_)
    for g, w in zip(card, cpu):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    for dtype in (torch.float32, torch.float64):
        assert torch.equal(quant.block_decode(*card, bits_,
                                              dtype=dtype).cpu(),
                           quant.block_decode(*cpu, bits_, dtype=dtype))


def _quant_case(device, method, dtype, bits_, k, per):
    """A quantized collective and its planes on `device`."""
    from tpu_reductions_torch import collectives as coll
    from tpu_reductions_torch.ops.dd_reduce import (host_key_encode,
                                                    host_split)
    mesh, x = _collective_case(device, k, per,
                               "float32" if dtype == "bfloat16" else dtype)
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    if dtype == "float64":
        hi, lo = (host_split(x.numpy()) if method == "SUM"
                  else host_key_encode(x.numpy()))
        planes = (coll.shard_payload(hi, mesh), coll.shard_payload(lo, mesh))
    else:
        planes = (coll.shard_payload(x, mesh),)
    fn = (coll.make_quant_sum_all_reduce(mesh, bits=bits_, dtype=dtype)
          if method == "SUM" else
          coll.make_quant_key_minmax_all_reduce(method, mesh, bits=bits_,
                                                dtype=dtype))
    return fn, planes


QUANT_CASES = ([("SUM", t, b) for t in ("float32", "bfloat16", "float64")
                for b in (4, 8, 16)]
               + [(m, t, b) for m in ("MIN", "MAX")
                  for t in ("float32", "float64") for b in (8, 16)])


@pytest.mark.gpu
@pytest.mark.parametrize("method, dtype, bits_", QUANT_CASES)
@pytest.mark.parametrize("k, per", [(2, 4096), (8, 4096), (8, 4088)])
def test_quant_collective_on_card_gives_the_cpu_bits(cuda_device, method,
                                                     dtype, bits_, k, per):
    """Every quantized ring and key collective (and the exact fallback of
    per = 4088) gives the CPU run's bits on every rank row; the fallback's
    psum adds in the card's order, and is held to float32's rtol."""
    out = []
    for device in (cuda_device, torch.device("cpu")):
        fn, planes = _quant_case(device, method, dtype, bits_, k, per)
        res = fn(*planes)
        res = res if isinstance(res, tuple) else (res,)
        out.append([r.cpu() for r in res])
    for got, want in zip(*out):
        if method == "SUM" and per % (k * 256):
            np.testing.assert_allclose(got.double().numpy(),
                                       want.double().numpy(), rtol=1e-6,
                                       atol=1e-6)
        else:
            assert torch.equal(bits(got), bits(want))
        assert all(torch.equal(bits(row), bits(got[0])) for row in got)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 17])
@pytest.mark.parametrize("method, dtype, bits_", [
    ("SUM", "float32", 8), ("SUM", "float32", 4), ("SUM", "bfloat16", 16),
    ("SUM", "float64", 8), ("MIN", "float32", 8), ("MAX", "float64", 16)])
def test_quant_graph_chain_gives_the_eager_chains_bits(cuda_device, method,
                                                       dtype, bits_, k):
    """The chained quantized collective replays one CUDA graph a trip: its
    scalar is the eager loop's on the card, and the CPU chain's."""
    from tpu_reductions_torch import collectives as coll
    from tpu_reductions_torch.ops.chain import ChainedReduce
    got = {}
    for name, device in (("graph", cuda_device), ("cpu", torch.device("cpu"))):
        fn, planes = _quant_case(device, method, dtype, bits_, 8, 4096)
        staged = planes if len(planes) == 2 else planes[0]
        chained = (coll.make_chained_pair_collective(method, fn)
                   if len(planes) == 2
                   else coll.make_chained_collective(method, coll=fn))
        got[name] = [chained(staged, k).cpu() for _ in range(2)]
        chained.close()
        if name == "graph":
            eager = ChainedReduce(chained.core, chained.op)
            # the eager loop on the card: the CPU path's loop, run on CUDA
            # tensors step by step
            cloned = tuple(p.clone() for p in planes)
            last = None
            for _ in range(k):
                last = eager._step(cloned, len(planes) == 2)
            got["eager"] = last.cpu()
    for g in got["graph"] + got["cpu"]:
        assert torch.equal(bits(g), bits(got["eager"]))


@pytest.mark.gpu
@pytest.mark.parametrize("pair, wire", [
    ("row_to_col", "exact"), ("row_to_col", "q8"),
    ("shard_to_replicated", "exact"), ("shard_to_replicated", "q4"),
    ("replicated_to_col", "exact"), ("partial_to_row", "exact")])
def test_reshard_cell_on_card(cuda_device, pair, wire):
    """One reshard cell per primitive (collective_permute, all_gather,
    dynamic_slice, reduce_scatter; the first two quantized too) on the
    card: PASSED, the accounted memory within declared, the allocator's
    peak read (at least the input and output rows the accounting counts
    for a step that allocates), and every rank's block the CPU run's bits
    (the partial pair's sum adds in the card's order and is held to its
    declared bound)."""
    from tpu_reductions_torch.bench import reshard_curve as rc
    from tpu_reductions_torch.reshard import (execute_plan, make_mesh,
                                              plan_reshard)
    k, n, rows = 8, 1 << 16, 64
    row = rc.measure_cell(pair, wire, k, n, rows, 0, platform="gpu")
    assert row["status"] == "PASSED", row
    assert row["measured_mem_factor"] <= row["mem_factor"]
    assert row["device_mem_factor"] > 0
    assert all(s["device_mem_factor"] is not None for s in row["steps"])
    kinds = {name: (s, d) for name, s, d in rc.PAIRS}
    src, dst = (rc._spec(kinds[pair][0], k), rc._spec(kinds[pair][1], k))
    qb = int(wire[1:]) if wire != "exact" else None
    plan = plan_reshard(src, dst, (rows, n // rows), 4, quant_bits=qb)
    rng = np.random.default_rng([0, k])
    carried = rng.standard_normal(((k,) if src.partial else ())
                                  + (rows, n // rows)).astype(np.float32)
    card, cpu = (execute_plan(plan, carried, make_mesh(k, platform))
                 ["shards"] for platform in ("gpu", "cpu"))
    for g, w in zip(card, cpu):
        if src.partial:
            np.testing.assert_allclose(g, w, rtol=0, atol=row["bound"])
        else:
            assert np.array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("method,dtype,quantized", [
    ("SUM", "int32", False), ("MIN", "int32", False),
    ("MAX", "int32", False), ("SUM", "float32", False),
    ("MAX", "bfloat16", False), ("SUM", "float32", True)])
def test_run_sharded_on_card_gives_the_cpu_result(cuda_device, method, dtype,
                                                  quantized):
    """The shard route at ranks=8 on one card: the same selection as the
    CPU run, int32 and MIN/MAX the same value, float SUM within the
    registry's tolerance (the card folds in another order), every
    response verified; the drain's reshard at 8 ranks verified with its
    measured memory factor at or under the declared one."""
    from tpu_reductions_torch.ops.registry import tolerance
    from tpu_reductions_torch.serve.autoscale import _reshard_partials
    from tpu_reductions_torch.serve.executor import BatchExecutor
    n = (1 << 20) + 37
    got, want = (BatchExecutor(p, ranks=8, cards=cards).run_sharded(
        method, dtype, n, 3, chunk_bytes=1 << 16, quantized=quantized)
        for p, cards in (("gpu", [torch.device("cuda", 0)]),
                         ("cpu", None)))
    assert got["ok"] is want["ok"] is True
    for key in ("algorithm", "wire_factor", "quantized", "devices",
                "per_device_chunks", "host"):
        assert got[key] == want[key], key
    assert got["note"] == "the 8 ranks are rows of one tensor on cuda"
    if dtype == "int32" or method != "SUM":
        assert got["result"] == want["result"]
    elif not quantized:
        assert abs(got["result"] - want["result"]) <= \
            2 * tolerance(method, dtype, n)
    res = _reshard_partials("v", executor=BatchExecutor("gpu", ranks=8),
                            mem_bound=2.0, seed=3)
    assert res["ok"] and res["measured_mem_factor"] <= res["mem_factor"]


# ---------------------------------------------------------------------------
# the serving shard route across the host's cards (serve/executor.py): each
# card folds its ranks' shards, the partials gathered onto cuda:0
# ---------------------------------------------------------------------------

@pytest.fixture
def host_cards():
    """Every card of the host; skips with fewer than two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs: run `python -m pytest "
                    "-q -m gpu --noconftest tests/test_torch_cuda.py -k "
                    "sharded_cards` on a machine with several cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


SHARDED_CARDS_ROWS = (("SUM", "int32", False), ("SUM", "float32", False),
                      ("SUM", "bfloat16", False), ("MIN", "int32", False),
                      ("SUM", "float32", True))


@pytest.mark.gpu
@pytest.mark.parametrize("method,dtype,quantized", SHARDED_CARDS_ROWS)
def test_sharded_cards_give_the_one_card_bits(host_cards, method, dtype,
                                              quantized):
    """run_sharded over every card (K = 2C) gives the bits, algorithm and
    selection of the same K on cuda:0 alone, every response verified."""
    from tpu_reductions_torch.serve.executor import BatchExecutor
    k, n = 2 * len(host_cards), (1 << 22) + 37
    got, want = (BatchExecutor("gpu", ranks=k, cards=cards).run_sharded(
        method, dtype, n, 3, chunk_bytes=1 << 20, quantized=quantized)
        for cards in (None, host_cards[:1]))
    assert got["ok"] is want["ok"] is True
    assert (got["cards"], want["cards"]) == (len(host_cards), 1)
    for key in ("result", "host", "algorithm", "wire_factor", "quantized",
                "devices", "per_device_chunks"):
        assert got[key] == want[key], key
    assert got["note"].startswith(f"{k} ranks on {len(host_cards)} cards")


@pytest.mark.gpu
def test_sharded_cards_put_each_partial_on_its_card(host_cards):
    """Before the gather rank r's partial lies on card r // (K / C) (the
    contiguous rule), each card folded its ranks' chunks, and each card's
    route onto cuda:0 is named."""
    from tpu_reductions_torch.device import rank_blocks
    from tpu_reductions_torch.ops.stream import plan_chunks
    from tpu_reductions_torch.serve.executor import BatchExecutor
    c = len(host_cards)
    k, n = 2 * c, (1 << 22) + 37
    ex = BatchExecutor("gpu", ranks=k)
    res = ex.run_sharded("SUM", "int32", n, 5, chunk_bytes=1 << 20)
    assert res["ok"]
    blocks = rank_blocks(k, c)
    want = [str(host_cards[i]) for i, b in enumerate(blocks) for _ in b]
    assert res["partials_on"] == want
    base = -(-n // k)
    elems = plan_chunks(base, "int32", 1 << 20).chunk_elems
    chunks = [-(-(min(n, (r + 1) * base) - r * base) // elems)
              for r in range(k)]
    assert res["card_chunks"] == [sum(chunks[r] for r in b) for b in blocks]
    assert res["gather_route"][0] == "local"
    assert set(res["gather_route"][1:]) <= {"peer", "host"}
    assert len(ex.last_shard["fold_cards"]) == c


# ---------------------------------------------------------------------------
# the rank ladder across the host's cards (bench/multicard.run_ladder): each
# rung's ranks on min(k, C) cards, one process a card, NCCL between them,
# against the same ladder on one card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ladder_cards(tmp_path_factory):
    """run_rank_scaling across C = min(4, cards) cards (ranks 2, 4, 8 at
    2^20; the curves at 2^20 over 2, 4, 8) and on cuda:0 alone, each with
    a Witness; skips with fewer than two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs: run `python -m pytest "
                    "-q -m gpu --noconftest tests/test_torch_cuda.py -k "
                    "ladder_cards` on a machine with several cards")
    import io
    from tpu_reductions_torch.bench import multicard, rank_scaling
    from tpu_reductions_torch.utils.logging import BenchLogger
    root = tmp_path_factory.mktemp("ladder_cards")
    c = min(4, torch.cuda.device_count())
    kw = dict(ranks=[2, 4, 8], n=1 << 20, retries=1, curve_n=1 << 20,
              rows=256, curve_ranks=[2, 4, 8], platform="gpu")
    runs = {}
    for cards in (c, 1):
        runs[cards] = rank_scaling.run_rank_scaling(
            root / f"c{cards}", cards=cards,
            witness=multicard.Witness(root / f"ev{cards}"),
            logger=BenchLogger(None, None, console=io.StringIO()), **kw)
    return root, c, runs


@pytest.mark.gpu
def test_ladder_cards_give_one_cards_bits_or_its_tolerance(ladder_cards):
    """Every row of the ladder across the cards (the sweep, the probe,
    both curves) PASSED and holds its one-card twin's bits where the rule
    asks (int32, MIN/MAX, the quantized rings, the reshard programs that
    only move data), else registry.tolerance."""
    from tpu_reductions_torch.bench import multicard
    root, c, runs = ladder_cards
    verdicts = multicard.ladder_agrees(root / f"ev{c}", root / "ev1")
    assert [v for v in verdicts if not v[2]] == []
    assert {v[0] for v in verdicts} == {"sweep", "probe", "quant",
                                        "reshard"}
    for run in runs.values():
        assert {r["status"] for r in run["sweep"]} == {"PASSED"}
        assert {r["status"] for r in run["quant"] + run["reshard"]} == \
            {"PASSED"}
        assert run["probe_dropped"] == []
    assert len(runs[c]["quant"]) == len(runs[1]["quant"])
    assert len(runs[c]["reshard"]) == len(runs[1]["reshard"])


@pytest.mark.gpu
def test_ladder_cards_place_each_rung(ladder_cards):
    """Rung k on min(k, C) cards, each sweep row with its busbw a card
    against NVLink; the shape names the placement."""
    root, c, runs = ladder_cards
    for r in runs[c]["sweep"]:
        assert r["cards"] == min(r["ranks"], c)
        assert r["nvlink_share"] == pytest.approx(
            r["busbw_gbps"] / r["cards"] / 450.0)
    assert runs[c]["shape"]["cards"] == c
    assert f"min(k, {c}) cards" in runs[c]["shape"]["note"]
    assert all("cards" not in r for r in runs[1]["sweep"])
    assert all(r["device_mem_factor"] is not None
               for r in runs[c]["reshard"])


@pytest.mark.gpu
@pytest.mark.parametrize("devices", [2, 6])
def test_ladder_cards_collective_cli_at_devices_that_do_not_divide(
        ladder_cards, devices):
    """The collective CLI in C processes at --devices=2 (two cards, the
    rest idle) and 6 (blocks 1, 2, 1, 2 on four): every process exits 0,
    rank 0 alone prints its rows and PASSED."""
    import sys
    from tpu_reductions_torch.bench import multicard
    _, c, _ = ladder_cards
    port = multicard.free_port()
    group = multicard.run_group(
        [[sys.executable, "-m",
          "tpu_reductions_torch.bench.collective_driver", "--method=SUM",
          "--type=int", "--n=4194304", f"--devices={devices}",
          "--retries=2", f"--num-processes={c}",
          f"--coordinator=127.0.0.1:{port}", f"--process-id={i}"]
         for i in range(c)], 240)
    assert group["rcs"] == [0] * c, group["outs"]
    assert group["survivors"] == []
    out0 = group["outs"][0][0]
    assert f"lie on {min(devices, c)} cards" in out0
    assert "&&&& tpu_reductions_torch.collective PASSED" in out0


@pytest.mark.gpu
def test_ladder_cards_sweep_cli(ladder_cards, tmp_path):
    """`python -m tpu_reductions_torch.bench.sweep` with its default
    --cards (every card of the host) exits 0 with rank 0's rows."""
    import json
    import sys
    from tpu_reductions_torch.bench import multicard
    _, c, _ = ladder_cards
    group = multicard.run_group(
        [[sys.executable, "-m", "tpu_reductions_torch.bench.sweep",
          "--ranks=2,8", "--n=1048576", "--types=int",
          f"--out-dir={tmp_path}"]], 300)
    assert group["rcs"] == [0], group["outs"]
    rows = json.loads((tmp_path / "collective_sweep.json").read_text())
    assert [r["cards"] for r in rows["rows"]] == \
        [min(r["ranks"], torch.cuda.device_count()) for r in rows["rows"]]
