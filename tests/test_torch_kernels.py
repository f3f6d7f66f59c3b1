"""The port's k6-k10 (tpu_reductions_torch/ops/kernel_reduce.py) held
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

Both packages stage the same numpy-seeded payload; the staged arrays must
be bit-equal, and then the port's plain versions (what its wrappers run
on CPU tensors) must match `single_pass_call`, `two_pass_call`,
`elementwise_call`, `stream_call` and `mxu_call` element by element:
bit-exact for int32 (wrapping adds) and MIN/MAX (selections), and for
float SUM within rtol 1e-6 (float32), 1e-12 (float64) and 1e-2 (bfloat16
data, float32 accumulator), because the two add in different orders.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py.
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

DTYPES = ("int32", "float32", "float64", "bfloat16")
METHODS = ("SUM", "MIN", "MAX")
SUM_RTOL = {"float32": 1e-6, "float64": 1e-12, "bfloat16": 1e-2}


def payload(n, dtype, method, seed=0):
    """numpy-seeded data: full-range int32 (SUM wraps), non-negative reals
    for SUM (so a relative tolerance means something), signed reals for
    MIN/MAX (so MAX's identity must lose to negatives)."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, size=n, dtype=np.int64
                            ).astype(np.int32)
    x = rng.random(n) if method == "SUM" else rng.standard_normal(n)
    return x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


def to_torch(a) -> torch.Tensor:
    """numpy/JAX array -> CPU tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def stage_both(x, method, threads, max_blocks):
    """Stage x in both packages; assert the staged arrays are bit-equal."""
    tm, p, t = pr.choose_tiling(x.size, threads, max_blocks, x.dtype)
    assert (tm, p, t) == kr.choose_tiling(x.size, threads, max_blocks,
                                          to_torch(x).dtype)
    x2d_jax = pr.stage_padded(x, tm, p, t, jax_get_op(method))
    x2d = kr.stage_padded(to_torch(x), tm, p, t, get_op(method))
    np.testing.assert_array_equal(bits(x2d), bits(to_torch(x2d_jax)))
    return x2d_jax, x2d, (tm, p, t)


def assert_acc_match(got: torch.Tensor, want, method, dtype):
    want_t = to_torch(want)
    assert got.shape == want_t.shape
    assert got.dtype == want_t.dtype
    if dtype == "int32" or method != "SUM":
        np.testing.assert_array_equal(bits(got), bits(want_t))
    else:
        np.testing.assert_allclose(got.double().numpy(),
                                   want_t.double().numpy(),
                                   rtol=SUM_RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kernel", [6, 7])
def test_plain_matches_pallas(kernel, method, dtype):
    # 33 rows: 5 tiles over 4 blocks (bf16: 3 tiles over 3 blocks)
    x = payload(4096 + 7, dtype, method)
    x2d_jax, x2d, (tm, p, t) = stage_both(x, method, threads=8, max_blocks=4)
    if kernel == 6:
        got = kr.single_pass_plain(x2d, get_op(method))
        want = pr.single_pass_call(x2d_jax, jax_get_op(method), tm,
                                   interpret=True)
    else:
        got = kr.two_pass_plain(x2d, get_op(method), tm, p, t)
        want = pr.two_pass_call(x2d_jax, jax_get_op(method), tm, p, t,
                                interpret=True)
    assert_acc_match(got, want, method, dtype)


@pytest.mark.parametrize("max_blocks", [1, 4, 64])
@pytest.mark.parametrize("threads", [8, 16, 256])
@pytest.mark.parametrize("n", [1000, 4096 + 7, 65536])
def test_geometry_grid_matches_pallas(n, threads, max_blocks):
    """Single-tile, multi-tile, multi-block geometries: the wrappers (which
    take the plain version on the CPU) against both JAX kernels."""
    x = payload(n, "int32", "SUM", seed=n)
    x2d_jax, x2d, (tm, p, t) = stage_both(x, "SUM", threads, max_blocks)
    op, jop = get_op("SUM"), jax_get_op("SUM")
    assert_acc_match(kr.single_pass_call(x2d, op),
                     pr.single_pass_call(x2d_jax, jop, tm, interpret=True),
                     "SUM", "int32")
    assert_acc_match(kr.two_pass_call(x2d, op, tm, p, t),
                     pr.two_pass_call(x2d_jax, jop, tm, p, t,
                                      interpret=True),
                     "SUM", "int32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_choose_tiling_agrees(dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    for n in (1, 127, 128, 129, 1000, 4096 + 7, 65536, 1 << 24, (1 << 24) + 37):
        for threads in (1, 8, 16, 24, 256, 384, 4096):
            for max_blocks in (1, 4, 64, 1000):
                assert kr.choose_tiling(n, threads, max_blocks, dtype) == \
                    pr.choose_tiling(n, threads, max_blocks, np_dtype)
    assert kr.sublanes_for(dtype) == pr.sublanes_for(np_dtype)


def _record_passes(monkeypatch, module, call_name):
    """Wrap module.two_pass_call to record each pass's (input rows,
    (tm, p, t) tiling, output shape)."""
    passes = []
    real = getattr(module, call_name)

    def recording(x2d, op, tm, p, t, **kwargs):
        out = real(x2d, op, tm, p, t, **kwargs)
        passes.append((x2d.shape[0], (tm, p, t), tuple(out.shape)))
        return out

    monkeypatch.setattr(module, call_name, recording)
    return passes


@pytest.mark.parametrize("case", [
    # (n, dtype, method, threads, max_blocks, cpu_thresh)
    (65536, "int32", "SUM", 8, 64, 1),       # tm == sublane, p == tiles:
    (65536, "int32", "MAX", 8, 1000, 1),     # the halving clamp's case
    (4096 + 7, "float32", "MIN", 16, 4, 1),
    (65536, "int32", "MIN", 16, 64, 40),     # stops at the threshold
    (65536, "bfloat16", "MIN", 16, 64, 1),   # bf16 partials: sub 16
    (65536, "bfloat16", "SUM", 16, 64, 1),   # f32 partials of bf16 data
])
def test_multipass_finish_matches_pallas(monkeypatch, case):
    """The port's chain runs the JAX chain's passes, each with its tiling
    and output shape, and gives its bits; each port pass takes the
    previous pass's partials as they are (no identity-padded copy), so
    its input has at most the rows its tiling covers."""
    n, dtype, method, threads, max_blocks, cpu_thresh = case
    x = payload(n, dtype, method)
    x2d_jax, x2d, (tm, p, t) = stage_both(x, method, threads, max_blocks)
    op, jop = get_op(method), jax_get_op(method)
    jax_passes = _record_passes(monkeypatch, pr, "two_pass_call")
    torch_passes = _record_passes(monkeypatch, kr, "two_pass_call")
    want = pr._multipass_finish(
        pr.two_pass_call(x2d_jax, jop, tm, p, t, interpret=True), jop,
        threads, max_blocks, cpu_thresh, interpret=True)
    got = kr._multipass_finish(kr.two_pass_call(x2d, op, tm, p, t), op,
                               threads, max_blocks, cpu_thresh)
    assert [ps[1:] for ps in torch_passes] == [ps[1:] for ps in jax_passes]
    assert len(torch_passes) >= 2
    for before, (rows, (tm2, p2, t2), _out) in zip(torch_passes,
                                                    torch_passes[1:]):
        assert rows == before[2][0] <= p2 * t2 * tm2
    assert_acc_match(got, want, method, dtype)


def _expect(x, method):
    if method == "SUM":
        return x.sum(dtype=np.int64).astype(np.int32)
    return x.min() if method == "MIN" else x.max()


@pytest.mark.parametrize("kernel", [6, 7])
@pytest.mark.parametrize("n", [1, 7, 128, 129, 1024, 4097, 8192, 100_000])
@pytest.mark.parametrize("method", ["MIN", "MAX"])
def test_nonpow2_minmax_regression(n, method, kernel):
    """The reference's min/max kernels read out of bounds for non-pow2 n;
    identity padding makes every size exact (tests/test_pallas_reduce.py's
    regression, on the port's one-shot entry point)."""
    rng = np.random.default_rng(n)
    x = rng.integers(-2**30, 2**30, size=n).astype(np.int32)
    got = kr.kernel_reduce(torch.from_numpy(x), method, threads=16,
                           max_blocks=4, kernel=kernel, device="cpu")
    assert got.item() == _expect(x, method)


@pytest.mark.parametrize("method, kwargs", [
    ("SUM", dict(kernel=7, cpu_thresh=4)),
    ("MIN", dict(kernel=7, cpu_final=True)),
    ("MAX", dict(kernel=6, cpu_final=True))])
def test_one_shot_matches_pallas_reduce(method, kwargs):
    x = payload(50_000, "int32", method, seed=1)
    want = pr.pallas_reduce(jnp.asarray(x), method, threads=16, max_blocks=8,
                            interpret=True, **kwargs)
    got = kr.kernel_reduce(torch.from_numpy(x), method, threads=16,
                           max_blocks=8, device="cpu", **kwargs)
    assert np.asarray(got).astype(np.int64) == np.asarray(want).astype(np.int64)


def _period_pair(kernel, x2d_jax, x2d, tm, method, depth=4):
    """(port, Pallas) accumulators of k8 or k10 on one staged input."""
    op, jop = get_op(method), jax_get_op(method)
    if kernel == 8:
        return (kr.elementwise_call(x2d, op, tm),
                pr.elementwise_call(x2d_jax, jop, tm, interpret=True))
    return (kr.stream_call(x2d, op, tm, depth),
            pr.stream_call(x2d_jax, jop, tm, interpret=True,
                           n_buffers=depth))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kernel", [8, 10])
def test_period_kernels_match_pallas(kernel, method, dtype):
    x = payload(4096 + 7, dtype, method)
    x2d_jax, x2d, (tm, _p, _t) = stage_both(x, method, threads=64,
                                            max_blocks=4)
    got, want = _period_pair(kernel, x2d_jax, x2d, tm, method)
    assert got.shape == (tm, 128)
    assert_acc_match(got, want, method, dtype)


@pytest.mark.parametrize("n", [4096 + 7, 65536 + 5])
@pytest.mark.parametrize("threads", [8, 64, 256])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("kernel", [8, 10])
def test_period_geometry_grid_matches_pallas(kernel, dtype, threads, n):
    """Tile heights from one sublane group up, on ragged payloads."""
    x = payload(n, dtype, "SUM", seed=n)
    x2d_jax, x2d, (tm, _p, _t) = stage_both(x, "SUM", threads, max_blocks=64)
    got, want = _period_pair(kernel, x2d_jax, x2d, tm, "SUM")
    assert_acc_match(got, want, "SUM", dtype)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("method, dtype", [
    ("SUM", "int32"), ("SUM", "float32"), ("MAX", "bfloat16"),
    ("MIN", "float64")])
def test_stream_depths_match_pallas(method, dtype, depth):
    """k10 at every depth of the JAX package's depth test: the depth never
    changes the accumulator, on either side."""
    x = payload(65536 + 5, dtype, method, seed=depth)
    x2d_jax, x2d, (tm, _p, _t) = stage_both(x, method, threads=64,
                                            max_blocks=64)
    got, want = _period_pair(10, x2d_jax, x2d, tm, method, depth)
    assert_acc_match(got, want, method, dtype)
    assert torch.equal(got, kr.stream_call(x2d, get_op(method), tm, 1))


@pytest.mark.parametrize("n", [4096 + 7, 65536 + 5])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_mxu_matches_pallas(dtype, n):
    """k9: rows 1-7 exactly zero in both; row 0 within the rtol."""
    x = payload(n, dtype, "SUM", seed=n)
    x2d_jax, x2d, (tm, _p, _t) = stage_both(x, "SUM", threads=256,
                                            max_blocks=64)
    got = kr.mxu_call(x2d, get_op("SUM"))
    want = to_torch(pr.mxu_call(x2d_jax, jax_get_op("SUM"), tm,
                                interpret=True))
    assert got.shape == want.shape == (8, 128)
    assert got.dtype == want.dtype
    assert not got[1:].any() and not want[1:].any()
    np.testing.assert_allclose(got[0].double().numpy(),
                               want[0].double().numpy(),
                               rtol=SUM_RTOL[dtype])


@pytest.mark.parametrize("method, dtype, match", [
    ("MIN", "float32", "SUM only"), ("MAX", "bfloat16", "SUM only"),
    ("SUM", "int32", "float dtype")])
def test_mxu_refuses_in_both_packages(method, dtype, match):
    x = payload(4096, dtype, method)
    x2d_jax, x2d, (tm, _p, _t) = stage_both(x, method, threads=64,
                                            max_blocks=4)
    with pytest.raises(ValueError, match=match):
        kr.mxu_call(x2d, get_op(method))
    with pytest.raises(ValueError):
        pr.mxu_call(x2d_jax, jax_get_op(method), tm, interpret=True)


def test_stream_refuses_ragged_rows_in_both_packages():
    x2d = torch.zeros((24, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows % tm"):
        kr.stream_call(x2d, get_op("SUM"), 16)
    with pytest.raises(ValueError, match="rows % tm"):
        pr.stream_call(jnp.zeros((24, 128), jnp.int32), jax_get_op("SUM"),
                       16, interpret=True)
    with pytest.raises(ValueError, match="positive"):
        kr.stream_call(x2d, get_op("SUM"), 8, 0)


@pytest.mark.parametrize("kernel", [8, 9, 10])
def test_one_shot_matches_pallas_reduce(kernel):
    method, dtype = ("SUM", "float32") if kernel == 9 else ("MAX", "int32")
    x = payload(50_000, dtype, method, seed=kernel)
    want = pr.pallas_reduce(jnp.asarray(x), method, threads=16, max_blocks=8,
                            kernel=kernel, stream_buffers=3, interpret=True)
    got = kr.kernel_reduce(torch.from_numpy(x), method, threads=16,
                           max_blocks=8, kernel=kernel, stream_buffers=3,
                           device="cpu")
    tol = 1e-8 * x.size if dtype == "float32" else 0.0
    assert abs(float(got) - float(np.asarray(want))) <= tol


def test_stream_max_depth_fits_shared_memory():
    """The deepest ring k10 accepts fits one block's shared memory beside
    its full and empty barriers; one stage more would not. A stage is
    whole SUB x 128 chunks, at most STREAM_STAGE_BYTES; plan_k10 takes the
    deepest ring and refuses one stage more."""
    assert kr.STREAM_BARRIER_BYTES == 2 * 8 * kr.STREAM_MAX_STAGES
    for dtype in (torch.int32, torch.float32, torch.float64, torch.bfloat16):
        sub = kr.sublanes_for(dtype)
        chunk = sub * 128 * dtype.itemsize
        deepest = kr.stream_max_depth(dtype)
        assert deepest >= 8
        plan = kr.plan_k10(64, 256, sub, dtype.itemsize, deepest, 132)
        stage = plan.chunks * chunk
        assert stage <= kr.STREAM_STAGE_BYTES < stage + chunk
        room = kr.SMEM_PER_BLOCK - kr.STREAM_BARRIER_BYTES
        assert deepest * stage <= room
        assert deepest == kr.STREAM_MAX_STAGES or (deepest + 1) * stage > room
        with pytest.raises(ValueError, match=f"at most {deepest} stages"):
            kr.plan_k10(64, 256, sub, dtype.itemsize, deepest + 1, 132)
