"""The port's coordinate-wise reduce (repro_torch.kernels / core.agg_engine)
against the JAX package's Pallas kernel, run in interpret mode as
tests/test_kernels.py runs it, and against the JAX plain references
(repro/kernels/ref.py). Inputs are numpy draws from a seed, handed to both.

Tolerance: rtol = atol = 1e-5, that of tests/test_kernels.py (the sums run
in another order in the two frameworks).

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against its plain version there (and skips without one), as does
chip_smoke.py over a wider sweep.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import agg_engine
from repro_torch.kernels import build, fused
from repro_torch.kernels import ref as kref

TOL = dict(rtol=1e-5, atol=1e-5)

MED_M = [3, 8, 16, 17, 25, 32]
MED_D = [64, 1000, 4096]
TM_CASES = [(8, 0), (8, 2), (16, 4), (17, 5), (32, 8)]
TM_D = [50, 2048]


def _cols(ds, d):
    """Column slice of ``d`` within the concatenation of ``ds``: one Pallas
    call per matrix serves every d (columns reduce independently)."""
    a = sum(ds[:ds.index(d)])
    return slice(a, a + d)


@functools.cache
def _stack(m, width, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(m, width)) * scale
            ).astype(np.float32)


@functools.cache
def _jax_med(m, bf16):
    x = jnp.asarray(_stack(m, sum(MED_D), m, 3.0))
    if bf16:
        x = x.astype(jnp.bfloat16)
    return np.asarray(jops.cwmed_op(x))


@functools.cache
def _jax_tm(m, trim):
    x = jnp.asarray(_stack(m, sum(TM_D), 100 + m + trim))
    return (np.asarray(jops.cwtm_op(x, trim)),
            np.asarray(jops.cwtm_masked_op(x, jnp.int32(trim))))


@functools.cache
def _jax_mean(m):
    x = jnp.asarray(_stack(m, sum(MED_D), 200 + m))
    return np.asarray(jops.fused_op(x, reduce="mean")["reduce"])


def _to_jax(x, bf16=False):
    xj = jnp.asarray(x)
    return xj.astype(jnp.bfloat16) if bf16 else xj


def _to_torch(x, bf16=False):
    xt = torch.from_numpy(np.ascontiguousarray(x))
    return xt.to(torch.bfloat16) if bf16 else xt


@pytest.mark.parametrize("m", MED_M)
@pytest.mark.parametrize("d", MED_D)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cw_median_matches_jax(m, d, bf16):
    x = _stack(m, sum(MED_D), m, 3.0)[:, _cols(MED_D, d)]
    got = agg_engine.cw_median(_to_torch(x, bf16)).numpy()
    np.testing.assert_allclose(got, _jax_med(m, bf16)[_cols(MED_D, d)], **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.cwmed_ref(_to_jax(x, bf16))),
                               **TOL)


@pytest.mark.parametrize("m,trim", TM_CASES)
@pytest.mark.parametrize("d", TM_D)
def test_cw_trimmed_mean_matches_jax(m, trim, d):
    x = _stack(m, sum(TM_D), 100 + m + trim)[:, _cols(TM_D, d)]
    xt = _to_torch(x)
    static = agg_engine.cw_trimmed_mean(xt, trim).numpy()
    masked = agg_engine.cw_trimmed_mean(xt, torch.tensor(trim)).numpy()
    j_static, j_masked = _jax_tm(m, trim)
    np.testing.assert_allclose(static, j_static[_cols(TM_D, d)], **TOL)
    np.testing.assert_allclose(masked, j_masked[_cols(TM_D, d)], **TOL)
    np.testing.assert_allclose(static, np.asarray(jref.cwtm_ref(x, trim)), **TOL)
    np.testing.assert_array_equal(static, masked)


@pytest.mark.parametrize("m", MED_M)
def test_cw_mean_matches_jax(m):
    x = _stack(m, sum(MED_D), 200 + m)
    got = agg_engine.cw_mean(_to_torch(x)).numpy()
    np.testing.assert_allclose(got, _jax_mean(m), **TOL)
    np.testing.assert_allclose(got, np.asarray(jnp.mean(x, axis=0)), **TOL)


def test_outlier_row_1e30():
    x = _stack(9, 256, 0).copy()
    x[0] = 1e30
    xj, xt = jnp.asarray(x), _to_torch(x)
    med = agg_engine.cw_median(xt).numpy()
    assert np.abs(med).max() < 10
    np.testing.assert_allclose(med, np.asarray(jops.cwmed_op(xj)), **TOL)
    tm = agg_engine.cw_trimmed_mean(xt, 2).numpy()
    np.testing.assert_allclose(tm, np.asarray(jops.cwtm_op(xj, 2)), **TOL)


def test_nan_column_gives_nan():
    x = _stack(17, 64, 1).copy()
    x[5, 3] = np.nan
    xj, xt = jnp.asarray(x), _to_torch(x)
    for got, want in [
        (agg_engine.cw_median(xt), jops.cwmed_op(xj)),
        (agg_engine.cw_trimmed_mean(xt, 8), jops.cwtm_op(xj, 8)),
        (agg_engine.cw_trimmed_mean(xt, 2), jops.cwtm_op(xj, 2)),
        (agg_engine.cw_mean(xt), jnp.mean(xj, axis=0)),
    ]:
        got, want = got.numpy(), np.asarray(want)
        assert np.isnan(got[3]) and np.isnan(want[3])
        np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


@pytest.mark.parametrize("mode", fused.REDUCE_MODES)
def test_wrapper_on_cpu_is_the_plain_version(mode):
    x = _to_torch(_stack(17, 300, 2))
    before = fused.LAUNCHES["cw_reduce"]
    got = fused.cw_reduce(x, mode, trim=8)
    want = {"med": kref.cwmed_ref(x), "tm": kref.cwtm_ref(x, 8),
            "mean": kref.cw_mean_ref(x)}[mode]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused.LAUNCHES["cw_reduce"] == before  # no kernel ran


def test_trim_is_clipped_to_leave_one_row():
    x = _to_torch(_stack(8, 40, 3))
    torch.testing.assert_close(fused.cwtm(x, 100), fused.cwmed(x), rtol=0, atol=0)
    torch.testing.assert_close(fused.cwtm(x, -1), fused.cwtm(x, 0), rtol=0, atol=0)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(65, 8), ValueError),  # more rows than the kernel sorts
    (torch.zeros(8, 6).t(), ValueError),  # not contiguous
    (torch.zeros(8), ValueError),  # not 2-D
    (torch.zeros(4, 8, dtype=torch.float64), TypeError),
    (torch.zeros(4, 8, dtype=torch.int32), TypeError),
])
def test_wrapper_rejects(bad, err):
    with pytest.raises(err):
        fused.cw_reduce(bad, "med")


def test_kernel_backend_on_cpu_raises():
    x = _to_torch(_stack(5, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        agg_engine.cw_trimmed_mean(x, 1, backend="kernel")
    assert agg_engine.dispatch_backend("auto", x) == "ref"
    with pytest.raises(ValueError, match="unknown backend"):
        agg_engine.cw_median(x, backend="pallas")


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
