"""The port's training path with each geometry rule against the JAX
package's, on the paper's Figure-1 setting (m=17 workers, 8 Byzantine,
sign_flip under Periodic(10), δ = 8/17 + 1e-3, MLMC T=150 / V=5 / j_cap=5 on
the Gaussian-mixture MLP): Krum, GeoMed and NNM+CWTM with sgd(0.1), and MFM
(Option 2, τ = mfm_tau(n) per level) with adagrad_norm(0.5).

Both packages get the same inputs through numpy, as in
tests/test_torch_main_path.py: the JAX package's params0, its index
sampler's batches and the (bitwise-equal) switchers' masks. The JAX side is
its per-round (legacy) driver on the ``ref`` backend. Tolerances: round logs
equal; params atol 1e-6 after T=12 rounds, as that file holds CWTM; the
per-call aggregation of ``_aggregate`` rtol = atol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.data import classification as j_clf
from repro.optim import optimizers as j_optim
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching
from repro_torch.data import classification as t_clf
from repro_torch.optim import optimizers as t_optim

M, N_BYZ, T = 17, 8, 150
DELTA = N_BYZ / M + 1e-3
MLMC_KW = dict(T=T, m=M, V=5.0, kappa=1.0, j_cap=5)

# rule -> (MLMC option, optimizer name, optimizer argument)
PATHS = {"krum": (1, "sgd", 0.1), "geomed": (1, "sgd", 0.1),
         "nnm+cwtm": (1, "sgd", 0.1), "mfm": (2, "adagrad_norm", 0.5)}


@pytest.fixture(scope="module")
def jax_task():
    return j_clf.make_task(M, seed=0)


@pytest.fixture(scope="module")
def torch_task():
    return t_clf.make_task(M, seed=0, device="cpu")


def _cfgs(rule, **kw):
    option = PATHS.get(rule, (1,))[0]
    common = dict(aggregator=rule, delta=DELTA, attack="sign_flip", **kw)
    return (j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(option=option, **MLMC_KW),
                               agg_backend="ref", **common),
            t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(option=option, **MLMC_KW),
                               **common))


def _indices(jax_task, t, n):
    return np.array(jax_task[2](t, n))


def _close(got_torch, want_jax, **tol):
    got = params_to_numpy(got_torch)
    assert sorted(got) == sorted(want_jax)
    for k in sorted(want_jax):
        np.testing.assert_allclose(got[k], np.asarray(want_jax[k]), err_msg=k,
                                   **tol)


def test_mfm_tau_matches_jax():
    for option in (1, 2):
        j = j_mlmc.MLMCConfig(option=option, **MLMC_KW)
        t = t_mlmc.MLMCConfig(option=option, **MLMC_KW)
        for n in (1, 2, 16, 32):
            assert t.mfm_tau(n) == j.mfm_tau(n)
        assert t.threshold(3) == pytest.approx(float(j.threshold(3)), rel=1e-7)


@pytest.mark.parametrize("rule,kw,n", [
    ("mfm", None, 1), ("mfm", None, 16), ("mfm", {"tau": 3.0}, 4),
    ("krum", {"multi": 3}, 4), ("geomed", {"iters": 3}, 2),
    ("nnm+cwtm", {"delta": 0.2}, 8)])
def test_aggregate_matches_jax(jax_task, torch_task, rule, kw, n):
    """``_aggregate`` with MFM's per-level threshold and rule kwargs, on the
    level-n gradient means of the Figure-1 task (computed by the port, whose
    per-unit gradients tests/test_torch_main_path.py holds to JAX's)."""
    idx = torch.from_numpy(_indices(jax_task, 5, n)).long()
    grads = t_rt._per_worker_grads(
        torch_task[1], params_from_numpy(jax_task[0], "cpu"), idx)
    stacked = {k: v.mean(1).numpy() for k, v in grads.items()}
    jcfg, tcfg = _cfgs(rule, aggregator_kwargs=kw)
    want = j_rt._aggregate(jcfg, {k: jnp.asarray(v) for k, v in stacked.items()},
                           n)
    got = t_rt._aggregate(tcfg, params_from_numpy(stacked, "cpu"), n)
    _close(got, want, rtol=1e-5, atol=1e-5)


def _optimizer(lib, rule):
    _, name, arg = PATHS[rule]
    return getattr(lib, name)(arg)


@pytest.mark.parametrize("rule", sorted(PATHS))
def test_run_dynabro_matches_jax(jax_task, torch_task, rule):
    T_run = 12
    jcfg, tcfg = _cfgs(rule)
    jstep = j_rt.make_dynabro_step(jax_task[1], jcfg, _optimizer(j_optim, rule))
    jp, jlogs, _ = j_rt.run_dynabro(
        jax_task[1], jax_task[0], _optimizer(j_optim, rule), jcfg,
        j_switching.get_switcher("periodic", M, n_byz=N_BYZ, K=10),
        jax_task[2], T_run, seed=0, step=jstep)
    tp, tlogs, _ = t_rt.run_dynabro(
        torch_task[1], params_from_numpy(jax_task[0], "cpu"),
        _optimizer(t_optim, rule), tcfg,
        t_switching.get_switcher("periodic", M, n_byz=N_BYZ, K=10),
        lambda t, n: torch.from_numpy(_indices(jax_task, t, n)).long(),
        T_run, seed=0)
    assert [vars(l) for l in tlogs] == [vars(l) for l in jlogs]
    assert len({l.level for l in tlogs}) > 1
    _close(tp, jp, rtol=0, atol=1e-6)
