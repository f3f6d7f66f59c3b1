"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports neither jax nor tpu_reductions, so it also runs on a machine
without JAX, with the repository's conftest.py (which imports jax) left
out:

    python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

int32 and MIN/MAX must be bit-equal; float SUM adds in another order and
is held to rtol 1e-6 (float32), 1e-12 (float64), 1e-2 (bfloat16 data,
float32 accumulator).
"""

import numpy as np
import pytest
import torch

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
    with pytest.raises(ValueError, match="rows for tiling"):
        kr.two_pass_call(x2d, op, 8, 4, 4)
    with pytest.raises(ValueError, match="no kernel for dtype"):
        kr.single_pass_call(x2d.to(torch.int64), op)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [6, 7])
def test_one_shot_reduce_on_card(cuda_device, kernel):
    x = payload(1_000_003, "int32", "SUM", seed=5)
    want = int(x.numpy().sum(dtype=np.int64).astype(np.int32))
    got = kr.kernel_reduce(x, "SUM", kernel=kernel, device=cuda_device)
    assert got.device.type == "cuda" and int(got) == want
