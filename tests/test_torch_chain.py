"""The port's chained reduction (ops/chain.py) held against the JAX
package's, on the CPU.

On a CPU tensor the port's chain is its plain path, the eager loop: k
iterations of the core, each folding its scalar into [0, 0] of a copy of
the staged tensor. Its scalar must be the JAX chain's (one compiled
`fori_loop`) for k = 1, 2 and 5, through kernel 6 on SUM/MIN/MAX x
int32/float32, and through the f64 pair kernel (the pair form, which
folds the first plane's scalar into the first plane). The JAX side runs
its Pallas kernels in interpret mode, as its own tests do. int32 and
MIN/MAX are exact; float32 SUM folds a float32 sum whose order of adds
differs between the packages, so it is held to 1e-6 relative (the value
grows with k, and each fold adds one rounding at float32's 6e-8); the
pair form's arithmetic is float32 adds in the same order on both sides
and its scalars are bit-equal.

On the card the same chain is one CUDA graph a trip; tests/
test_torch_cuda.py holds its bits against this loop's and its launch
counters against the replays.
"""

import numpy as np
import pytest
import torch

from tpu_reductions.ops import chain as jax_chain
from tpu_reductions.ops import dd_reduce as jax_dd
from tpu_reductions.ops import pallas_reduce
from tpu_reductions.ops.registry import get_op as jax_get_op
from tpu_reductions_torch.ops import chain
from tpu_reductions_torch.ops import dd_reduce as dd
from tpu_reductions_torch.ops import kernel_reduce as kr
from tpu_reductions_torch.ops.registry import get_op
from torch_routes import fixed_slopes  # noqa: F401

CPU = torch.device("cpu")
N = 8192 + 5
KS = (1, 2, 5)


def payload(dtype: str, method: str, seed: int = 3) -> np.ndarray:
    """int32 over the full range (SUM wraps), float32 non-negative for
    SUM and signed for MIN/MAX, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, size=N).astype(np.int32)
    x = rng.random(N) if method == "SUM" else rng.standard_normal(N)
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
def test_eager_chain_matches_the_jax_chain(method, dtype):
    x = payload(dtype, method)
    jop, jstage, jcore = pallas_reduce.make_staged_core(method, N, dtype)
    jchained = jax_chain.make_chained_reduce(jcore, jop)
    jx2d = jstage(x)
    op, stage, core = kr.make_staged_core(method, N, dtype, device=CPU)
    chained = chain.make_chained_reduce(core, op)
    x2d = stage(torch.from_numpy(x))
    for k in KS:
        want = np.asarray(jchained(jx2d, k))
        got = chained(x2d, k).numpy()
        assert got.dtype == want.dtype
        if dtype == "int32" or method != "SUM":
            assert got == want, (k, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
def test_pair_chain_matches_the_jax_chain(method):
    x = np.random.default_rng(5).uniform(-1, 1, N)
    jstage, jcore, _ = jax_dd.make_dd_device_reduce(method, N)
    jchained = jax_chain.make_chained_reduce(jcore, jax_get_op(method))
    jhi, jlo, jscale = jstage(x)
    stage, core, _ = dd.make_dd_device_reduce(method, N, device=CPU)
    chained = chain.make_chained_reduce(core, get_op(method))
    hi2d, lo2d, scale = stage(x)
    assert scale == jscale
    for k in KS:
        want = np.asarray(jchained((jhi, jlo), k))
        got = chained((hi2d, lo2d), k).numpy()
        assert got.dtype == want.dtype
        assert got.view(np.int32) == want.view(np.int32), (k, got, want)


def test_chain_refuses_no_iterations_and_closes():
    op, stage, core = kr.make_staged_core("SUM", N, "int32", device=CPU)
    chained = chain.make_chained_reduce(core, op)
    x2d = stage(torch.from_numpy(payload("int32", "SUM")))
    with pytest.raises(ValueError, match="k >= 1"):
        chained(x2d, 0)
    assert int(chained(x2d, 1)) == int(core(x2d))
    chained.close()         # nothing held on the CPU; a no-op there


@pytest.mark.parametrize("method", ["SUM", "MIN", "MAX"])
def test_fold_is_the_ops_combine_in_place(method):
    op = get_op(method)
    first = torch.tensor([[5, 9], [1, 2]], dtype=torch.int32)
    rest = first.clone()
    chain.fold_into(first, torch.tensor(7, dtype=torch.int32), op)
    want = {"SUM": 12, "MIN": 5, "MAX": 7}[method]
    assert int(first[0, 0]) == want
    assert torch.equal(first.view(-1)[1:], rest.view(-1)[1:])


def test_counted_wrappers_are_the_six_kernels():
    assert chain.counted_wrappers() == (
        kr.single_pass_call, kr.two_pass_call, kr.elementwise_call,
        kr.mxu_call, kr.stream_call, dd.dd_call)


def test_a_chained_row_closes_its_chain_and_traces_it(tmp_path, monkeypatch,
                                                      fixed_slopes):
    """The driver times a chained row through its chain and closes it;
    --trace of a chained row traces the chain (on the card, its graph's
    replays), and the row still verifies on the unperturbed tensor."""
    import io
    import json

    from tpu_reductions_torch.bench import driver
    from tpu_reductions_torch.config import ReduceConfig
    from tpu_reductions_torch.utils.debug import TRACE_FILE
    from tpu_reductions_torch.utils.logging import BenchLogger
    closed, traced = [], []
    monkeypatch.setattr(chain.ChainedReduce, "close",
                        lambda self: closed.append(self))
    real = driver.trace_benchmark

    def spy(fn, *args, **kwargs):
        traced.append(args[0])
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(driver, "trace_benchmark", spy)
    for f64 in ("native", "dd"):
        res = driver.run_benchmark(
            ReduceConfig(method="SUM", dtype="float64", n=4096 + 3,
                         f64=f64, timing="chained", iterations=4,
                         chain_reps=2, platform="cpu",
                         trace_dir=str(tmp_path / f64), log_file=None),
            logger=BenchLogger(console=io.StringIO()))
        assert res.passed and res.timing == "chained"
        assert json.loads((tmp_path / f64 / TRACE_FILE).read_text())
    assert len(closed) == 2
    # the pair route's chain folds the two planes, not the scale
    assert isinstance(traced[1], tuple) and len(traced[1]) == 2
