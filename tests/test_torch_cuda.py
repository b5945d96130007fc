"""The CUDA kernel of the port against its plain PyTorch version, on the
card. Every test here needs a CUDA device and skips without one; this file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: rtol = atol = 1e-5 (the kernel sums in row order, the plain
version in torch's order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _stack(m, d, seed, dtype):
    x = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("m", [1, 2, 3, 17, 32, 33, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain(cuda_device, m, dtype):
    x = _stack(m, 9610, m, dtype)
    xd = x.to(cuda_device)
    before = fused.LAUNCHES["cw_reduce"]
    cases = [("med", 0), ("mean", 0), ("tm", 0), ("tm", (m - 1) // 2)]
    for mode, trim in cases:
        got = fused.cw_reduce(xd, mode, trim).cpu()
        torch.testing.assert_close(got, fused.cw_reduce(x, mode, trim), **TOL)
    assert fused.LAUNCHES["cw_reduce"] == before + len(cases)


def test_masked_trim_on_card(cuda_device):
    xd = _stack(17, 1000, 0, torch.float32).to(cuda_device)
    for trim in range(9):
        t = torch.tensor(trim, device=cuda_device)
        torch.testing.assert_close(fused.cwtm_masked(xd, t), fused.cwtm(xd, trim),
                                   rtol=0, atol=0)


def test_nan_column_and_outlier_on_card(cuda_device):
    x = _stack(17, 300, 1, torch.float32)
    x[0] = 1e30
    x[4, 7] = float("nan")
    xd = x.to(cuda_device)
    for mode in fused.REDUCE_MODES:
        got = fused.cw_reduce(xd, mode, 8).cpu()
        assert torch.isnan(got[7])
        torch.testing.assert_close(got, fused.cw_reduce(x, mode, 8),
                                   equal_nan=True, **TOL)
