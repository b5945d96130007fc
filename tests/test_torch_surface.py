"""Public names and arguments of modules the port has whole, against the JAX
package, on the CPU: ``optim.get_optimizer``, ``data``'s classification
exports, ``make_task(noise=)``, ``make_index_sampler(n_train=)``,
``Krum.scores`` and ``MFM.__call__``.

Tolerance: rtol 1e-5, atol 1e-6 (the same float32 formulas, summed in
another order); the Krum scores and MFM's output at atol 1e-5 of the
largest distance (a sum of squared distances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data
import repro.optim
from repro.core import aggregators as j_agg
from repro.data import classification as j_clf
from repro.optim import optimizers as j_optim
import repro_torch.data
import repro_torch.optim
from repro_torch.core import aggregators as t_agg
from repro_torch.data import classification as t_clf

TOL = dict(rtol=1e-5, atol=1e-6)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_optim_and_data_export_the_jax_packages_names():
    assert set(repro.optim.__all__) <= set(repro_torch.optim.__all__)
    assert set(repro.data.__all__) <= set(repro_torch.data.__all__)
    for name in repro_torch.data.__all__ + repro_torch.optim.__all__:
        assert (getattr(repro_torch.data, name, None)
                or getattr(repro_torch.optim, name))


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {"beta": 0.8}), ("adam", {"b1": 0.5}),
    ("adagrad_norm", {})])
def test_get_optimizer_matches_jax(name, kw):
    """Three updates of each registered optimizer from ``get_optimizer``,
    the JAX package's and the port's, on the same gradients."""
    jopt = j_optim.get_optimizer(name, 0.1, **kw)
    topt = repro_torch.optim.get_optimizer(name, 0.1, **kw)
    assert topt.name == jopt.name
    params = {"a": _normal(0, (3, 4)), "b": _normal(1, (5,))}
    js = jopt.init(jax.tree.map(jnp.asarray, params))
    ts = topt.init({k: torch.from_numpy(v) for k, v in params.items()})
    for step in range(3):
        g = {"a": _normal(10 + step, (3, 4)), "b": _normal(20 + step, (5,))}
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in g:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       err_msg=f"{name} {k} {step}", **TOL)


def test_get_optimizer_unknown_name_raises_as_jax():
    with pytest.raises(KeyError):
        j_optim.get_optimizer("nosuch", 0.1)
    with pytest.raises(KeyError):
        repro_torch.optim.get_optimizer("nosuch", 0.1)


def test_classification_exports_match_jax():
    """``init_clf``, ``clf_logits`` and ``clf_loss`` from ``repro_torch.data``:
    the JAX package's weights and batch through both."""
    params = {k: np.asarray(v) for k, v in
              j_clf.init_clf(jax.random.PRNGKey(3)).items()}
    x = _normal(4, (7, 64))
    y = np.random.default_rng(5).integers(0, 10, 7).astype(np.int32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    np.testing.assert_allclose(
        repro_torch.data.clf_logits(tp, torch.from_numpy(x)).numpy(),
        np.asarray(repro.data.clf_logits(params, x)), **TOL)
    np.testing.assert_allclose(
        float(repro_torch.data.clf_loss(tp, (torch.from_numpy(x),
                                             torch.from_numpy(y).long()))),
        float(repro.data.clf_loss(params, (x, y))), **TOL)
    init = repro_torch.data.init_clf(3, device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in params.items()}


@pytest.mark.parametrize("noise", [0.5, 2.0])
def test_make_task_noise_matches_jax(noise):
    """``make_task(noise=)``: the same mixture as the JAX package's (the
    gradient of the same weights on the same indices, and the test
    accuracy), and another one than the default noise's."""
    jp, jgrad, _, jeval = j_clf.make_task(17, seed=1, noise=noise)
    _, tgrad, _, teval = t_clf.make_task(17, seed=1, noise=noise, device="cpu")
    _, tgrad1, _, _ = t_clf.make_task(17, seed=1, device="cpu")
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    idx = np.random.default_rng(0).integers(0, 20000, 32).astype(np.int32)
    want = jgrad(jp, jnp.asarray(idx))
    got = tgrad(params, torch.from_numpy(idx).long())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert teval(params, 0)["test_acc"] == pytest.approx(
        jeval(jp, 0)["test_acc"], abs=1e-6)
    other = tgrad1(params, torch.from_numpy(idx).long())
    assert not torch.equal(other["w1"], got["w1"])


@pytest.mark.parametrize("n_train", [1, 50, 20000])
def test_make_index_sampler_n_train(n_train):
    """``make_index_sampler(n_train=)``: (m, k, unit_batch) indices in [0,
    n_train), as the JAX package's; the default is the training set's
    20000 and draws the indices it drew before."""
    js = j_clf.make_index_sampler(3, 8, seed=2, n_train=n_train)
    ts = t_clf.make_index_sampler(3, 8, seed=2, n_train=n_train, device="cpu")
    j_idx, t_idx = np.asarray(js(4, 5)), ts(4, 5)
    assert t_idx.shape == j_idx.shape == (3, 5, 8)
    assert int(t_idx.min()) >= 0 and int(t_idx.max()) < n_train
    assert int(j_idx.min()) >= 0 and int(j_idx.max()) < n_train
    if n_train == 20000:
        default = t_clf.make_index_sampler(3, 8, seed=2, device="cpu")
        assert torch.equal(default(4, 5), t_idx)
    if n_train == 1:
        assert int(t_idx.max()) == 0


@pytest.mark.parametrize("m", [5, 17])
def test_krum_scores_match_jax(m):
    x = _normal(m, (m, 40))
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1).astype(np.float32)
    for delta in (0.1, 0.3):
        want = np.asarray(j_agg.Krum(delta).scores(jnp.asarray(d2)))
        got = t_agg.Krum(delta).scores(torch.from_numpy(d2)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(d2.max()))


@pytest.mark.parametrize("tau", [0.5, 3.0, 8.0])
def test_mfm_call_matches_jax(tau):
    """``MFM()(x, tau)`` on one (m, d) stack, and with ``tau`` set at
    construction; the input is taken in float32."""
    x = np.concatenate([_normal(0, (12, 30), 0.3), _normal(1, (5, 30), 4.0)])
    want = np.asarray(j_agg.MFM()(jnp.asarray(x), tau))
    got = t_agg.MFM(backend="ref")(torch.from_numpy(x).double(), tau)
    assert got.dtype == torch.float32 and got.shape == (30,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    again = t_agg.MFM(tau, backend="ref")(torch.from_numpy(x))
    assert torch.equal(again, got)
