"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; this file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol = atol = 1e-5 for the reduce and combine kernels (they sum
in row order, the plain versions in torch's order). The distance kernels
are held to atol 2e-6 after dividing both sides by the larger of the
largest distance and the largest squared row norm: the Gram expansion
cancels relative to the row norms, so at m = 1 the only distance is that
cancellation residue.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import agg_engine
from repro_torch.kernels import fused
from repro_torch.kernels import ref as kref

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)
GEOMETRY_M = [1, 2, 3, 17, 32, 64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _stack(m, d, seed, dtype):
    x = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _dist_close(got, want, *rows):
    """Distances equal where not finite, and within atol 2e-6 of each other
    after scaling by the largest finite distance or squared row norm."""
    got, want = got.cpu(), want.cpu()
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    torch.testing.assert_close(got[~finite], want[~finite], equal_nan=True,
                               rtol=0, atol=0)
    norms = torch.cat([r.cpu().float().square().sum(1) for r in rows])
    norms = norms[torch.isfinite(norms)]
    scale = max(float(want[finite].max()) if finite.any() else 0.0,
                float(norms.max()) if norms.numel() else 0.0, 1e-30)
    torch.testing.assert_close(got[finite] / scale, want[finite] / scale,
                               rtol=0, atol=2e-6)


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


# ------------------------------------------------- geometry kernels


@pytest.mark.parametrize("m", GEOMETRY_M)
@pytest.mark.parametrize("d", [10, 777, 9610])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_distances_match_plain(cuda_device, m, d, dtype):
    x = _stack(m, d, 10 + m, dtype)
    y = _stack(2, d, 20 + m, dtype)
    xd, yd = x.to(cuda_device), y.to(cuda_device)
    before = dict(fused.LAUNCHES)
    pw = fused.pairwise_sqdist(xd)
    _dist_close(pw, kref.pairwise_sqdist_ref(x), x)
    assert torch.equal(pw, pw.T)
    _dist_close(fused.cross_sqdist(xd, yd[:1]), kref.cross_sqdist_ref(x, y[:1]),
                x, y)
    _dist_close(fused.cross_sqdist(xd, yd), kref.cross_sqdist_ref(x, y), x, y)
    assert fused.LAUNCHES["pairwise_sqdist"] == before["pairwise_sqdist"] + 1
    assert fused.LAUNCHES["cross_sqdist"] == before["cross_sqdist"] + 2


@pytest.mark.parametrize("m", GEOMETRY_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_combine_matches_plain(cuda_device, m, dtype):
    x = _stack(m, 9610, 30 + m, dtype)
    xd = x.to(cuda_device)
    rng = np.random.default_rng(m)
    for k in sorted({1, m}):
        w = torch.from_numpy(rng.random((k, m)).astype(np.float32))
        wd = w.to(cuda_device)
        before = dict(fused.LAUNCHES)
        torch.testing.assert_close(fused.weighted_combine(xd, wd).cpu(),
                                   kref.weighted_combine_ref(x, w), **TOL)
        cases = [("med", 0), ("mean", 0), ("tm", 0), ("tm", (k - 1) // 2)]
        for mode, trim in cases:
            torch.testing.assert_close(
                fused.combine_reduce(xd, wd, mode, trim).cpu(),
                kref.combine_reduce_ref(x, w, mode, trim), **TOL)
        assert fused.LAUNCHES["weighted_combine"] == before["weighted_combine"] + 1
        assert (fused.LAUNCHES["combine_reduce"]
                == before["combine_reduce"] + len(cases))


def test_fused_pass_stage_subsets_on_card(cuda_device):
    x = _stack(17, 2000, 3, torch.float32)
    w = torch.from_numpy(np.random.default_rng(3).random((17, 17)).astype(
        np.float32))
    xd, wd = x.to(cuda_device), w.to(cuda_device)
    for stages in [dict(pairwise=True), dict(combine=True),
                   dict(reduce="tm", trim=8), dict(reduce="med", combine=True),
                   dict(reduce="mean", pairwise=True, combine=True)]:
        got = fused.fused_pass(xd, w=wd, **stages)
        want = fused.fused_pass(x, w=w, **stages)
        assert sorted(got) == sorted(want)
        for key in want:
            if key == "pairwise":
                _dist_close(got[key], want[key], x)
            else:
                torch.testing.assert_close(got[key].cpu(), want[key], **TOL)


def test_geometry_edge_inputs_on_card(cuda_device):
    x = _stack(17, 9610, 4, torch.float32)
    x[0] = 1e30
    x[5, 3] = float("nan")
    xd = x.to(cuda_device)
    z = x[1:2].clone()
    _dist_close(fused.pairwise_sqdist(xd), kref.pairwise_sqdist_ref(x), x)
    _dist_close(fused.cross_sqdist(xd, z.to(cuda_device)),
                kref.cross_sqdist_ref(x, z), x, z)
    w = torch.full((17, 17), 1.0 / 17)
    for mode in fused.REDUCE_MODES:
        got = fused.combine_reduce(xd, w.to(cuda_device), mode, 8).cpu()
        assert torch.isnan(got[3])
        torch.testing.assert_close(got, kref.combine_reduce_ref(x, w, mode, 8),
                                   equal_nan=True, **TOL)


def test_distances_rerun_bitwise(cuda_device):
    xd = _stack(17, 9610, 5, torch.float32).to(cuda_device)
    assert torch.equal(fused.pairwise_sqdist(xd), fused.pairwise_sqdist(xd))
    assert torch.equal(fused.cross_sqdist(xd, xd[:1]),
                       fused.cross_sqdist(xd, xd[:1]))


@pytest.mark.parametrize("name", ["krum", "geomed", "nnm+cwtm", "nnm+mean",
                                  "nnm+krum", "mfm"])
def test_rules_on_card_match_plain(cuda_device, name):
    """12 workers near one point and 5 far from it, so that every rule's
    choices (Krum's pick, NNM's neighbours, MFM's filter) are clear-cut."""
    rng = np.random.default_rng(6)
    shapes = {"b1": (128,), "b2": (10,), "w1": (64, 128), "w2": (128, 10)}
    far = np.isin(np.arange(17), [2, 5, 8, 11, 14])
    stacked = {}
    for k, s in shapes.items():
        v = rng.normal(size=s) + 0.1 * rng.normal(size=(17,) + s)
        v[far] += 5.0
        stacked[k] = torch.from_numpy(v.astype(np.float32))
    kw = dict(tau=40.0) if name == "mfm" else {}
    want = agg_engine.get_aggregator(name, delta=0.3, backend="ref", **kw).tree(
        stacked)
    got = agg_engine.get_aggregator(name, delta=0.3, backend="kernel", **kw).tree(
        {k: v.to(cuda_device) for k, v in stacked.items()})
    for k in shapes:
        torch.testing.assert_close(got[k].cpu(), want[k], **TOL)
