"""The port's host-side schedules, counts, data, MLMC combine and optimizers
against the JAX package's, on the same numpy inputs.

Schedules, counts and data are plain numpy in both packages and must be
array-equal. The MLMC combine and the optimizers run float32 arithmetic in
another framework, so they are held to rtol = atol = 1e-6 (a few float32
ulps at these magnitudes); the fail-safe bound and decision must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agg_engine as j_engine
from repro.core import attacks as j_attacks
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.data import pipeline as j_pipeline
from repro.optim import optimizers as j_optim
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import agg_engine as t_engine
from repro_torch.core import attacks as t_attacks
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching
from repro_torch.data import pipeline as t_pipeline
from repro_torch.optim import optimizers as t_optim

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"w1": (6, 5), "b1": (5,), "w2": (5, 3), "b2": (3,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got_torch, want_jax, **tol):
    got = params_to_numpy(got_torch)
    assert sorted(got) == sorted(want_jax)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want_jax[k]),
                                   **(tol or TOL), err_msg=k)


# --------------------------------------------------------------- schedules


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("j_max", [1, 3, 5, 7])
def test_level_schedule_equal(seed, j_max):
    want = j_mlmc.level_schedule(np.random.default_rng(seed), j_max, 300)
    got = t_mlmc.level_schedule(np.random.default_rng(seed), j_max, 300)
    np.testing.assert_array_equal(got, want)


SWITCHERS = [
    ("static", 9, dict(n_byz=3)),
    ("periodic", 17, dict(n_byz=8, K=10)),
    ("bernoulli", 10, dict(p=0.3, D=2, delta_max=0.3)),
    ("momentum_tailored", 9, dict(alpha=0.1)),
]


@pytest.mark.parametrize("name,m,kw", SWITCHERS, ids=[s[0] for s in SWITCHERS])
@pytest.mark.parametrize("seed", [0, 3])
def test_mask_schedule_equal(name, m, kw, seed):
    want = j_switching.get_switcher(name, m, seed=seed, **kw)
    got = t_switching.get_switcher(name, m, seed=seed, **kw)
    np.testing.assert_array_equal(got.mask_schedule(64, 4),
                                  want.mask_schedule(64, 4))
    for t in range(0, 64, 5):
        np.testing.assert_array_equal(got.within_round(t, 1),
                                      want.within_round(t, 1))
    assert got.switch_rounds(64) == want.switch_rounds(64)


def test_counts_equal():
    assert t_engine.count_ceil(0.28 * 25) == j_engine.count_ceil(0.28 * 25) == 7
    assert t_engine.count_floor(0.3 * 10) == j_engine.count_floor(0.3 * 10) == 3
    assert t_engine.trim_count(8 / 17 + 1e-3, 17) == 8
    for m in range(1, 33):
        for delta in np.linspace(0.0, 0.5, 41):
            assert (t_engine.trim_count(delta, m)
                    == j_engine.trim_count(delta, m)), (delta, m)
            assert (t_engine.count_floor(delta * m)
                    == j_engine.count_floor(delta * m)), (delta, m)


@pytest.mark.parametrize("seed,noise", [(0, 1.0), (5, 0.5)])
def test_gaussian_mixture_dataset_equal(seed, noise):
    want = j_pipeline.gaussian_mixture_dataset(10, 64, 3000, seed=seed, noise=noise)
    got = t_pipeline.gaussian_mixture_dataset(10, 64, 3000, seed=seed, noise=noise)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- MLMC


@pytest.mark.parametrize("m,T,V,option", [(17, 150, 5.0, 1), (9, 64, 0.3, 2),
                                          (5, 1000, 2.0, 1)])
def test_failsafe_threshold_equal(m, T, V, option):
    kw = dict(T=T, m=m, V=V, option=option, kappa=1.0, j_cap=7)
    want, got = j_mlmc.MLMCConfig(**kw), t_mlmc.MLMCConfig(**kw)
    assert got.j_max == want.j_max
    for j in range(1, 9):
        assert got.threshold(j) == float(want.threshold(j)), j


@pytest.mark.parametrize("V,j,branch,failsafe", [
    (50.0, 3, "accepted", True),  # the correction passes the fail-safe
    (1e-3, 3, "rejected", True),  # the correction is dropped
    (1e-3, 3, "accepted", False),  # no fail-safe: always applied
    (5.0, 6, "beyond_cap", True),  # j > j_max: level 0 alone
])
def test_mlmc_combine(V, j, branch, failsafe):
    kw = dict(T=150, m=17, V=V, kappa=1.0, j_cap=5, use_failsafe=failsafe)
    jcfg, tcfg = j_mlmc.MLMCConfig(**kw), t_mlmc.MLMCConfig(**kw)
    g0, gjm1, gj = _tree(0), _tree(1, 0.1), _tree(2, 0.1)
    tin = [params_from_numpy(t, "cpu") for t in (g0, gjm1, gj)]
    jin = [{k: jnp.asarray(v) for k, v in t.items()} for t in (g0, gjm1, gj)]
    want, winfo = j_mlmc.mlmc_combine(*jin, j, jcfg)
    got, ginfo = t_mlmc.mlmc_combine(*tin, j, tcfg)
    _close(got, want)
    ok = bool(ginfo["failsafe_ok"])
    assert ok == bool(winfo["failsafe_ok"])
    assert ok == (branch != "rejected")
    np.testing.assert_allclose(float(ginfo["corr_norm"]),
                               float(winfo["corr_norm"]), rtol=1e-6)
    if branch == "rejected":
        _close(got, g0, rtol=0, atol=0)


# --------------------------------------------------------------- optimizers

OPTIMIZERS = [
    ("sgd", lambda lib: lib.sgd(0.1)),
    ("momentum", lambda lib: lib.momentum(0.05, beta=0.9)),
    ("adam", lambda lib: lib.adam(1e-2)),
    ("adagrad_norm", lambda lib: lib.adagrad_norm(0.5)),
]


@pytest.mark.parametrize("name,make", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_steps(name, make):
    jopt, topt = make(j_optim), make(t_optim)
    p0 = _tree(10)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = params_from_numpy(p0, "cpu")
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _tree(20 + step)
        ju, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        tu, tstate = topt.update(params_from_numpy(g, "cpu"), tstate, tp)
        jp = j_optim.apply_updates(jp, ju)
        tp = t_optim.apply_updates(tp, tu)
        _close(tp, jp)
    assert all(v.dtype == torch.float32 for v in tp.values())


# --------------------------------------------------------------- attacks


@pytest.mark.parametrize("attack,kwargs", [("none", None), ("sign_flip", None),
                                           ("sign_flip", {"scale": 2.5})])
def test_attack_stack_matches_jax(attack, kwargs):
    """(m, n, ...) grads with a different Byzantine set per computation k."""
    m, n = 7, 4
    rng = np.random.default_rng(3)
    grads = {k: rng.normal(size=(m, n) + s).astype(np.float32)
             for k, s in SHAPES.items()}
    masks = rng.random((n, m)) < 0.4
    mlmc_kw = dict(T=16, m=m, V=1.0)
    jcfg = j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**mlmc_kw), attack=attack,
                              attack_kwargs=kwargs)
    tcfg = t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**mlmc_kw), attack=attack,
                              attack_kwargs=kwargs)
    want = j_rt._attack_stack(jcfg, {k: jnp.asarray(v) for k, v in grads.items()},
                              jnp.asarray(masks), jax.random.PRNGKey(0))
    got = t_rt._attack_stack(tcfg, params_from_numpy(grads, "cpu"),
                             torch.from_numpy(masks))
    _close(got, want, rtol=0, atol=0)


# --------------------------------------------------------------- registries


def test_unported_rules_and_attacks_say_so():
    """Every class rule and every attack is ported: each JAX name resolves,
    and unknown names of either raise."""
    assert t_engine.get_aggregator("CWTM", delta=0.3).delta == 0.3
    assert t_engine.registered_rules() == j_engine.registered_rules()
    for name in ("krum", "geomed", "mfm", "nnm+cwtm", "nnm+krum"):
        assert t_engine.get_aggregator(name).name == name
    for name in ("nosuch", "nnm+nosuch", "nnm"):
        with pytest.raises(ValueError, match="unknown aggregator"):
            t_engine.get_aggregator(name)
    assert sorted(t_attacks.ATTACKS) == sorted(j_attacks.ATTACKS)
    for name in j_attacks.ATTACKS:
        assert callable(t_attacks.get_attack(name))
    with pytest.raises(ValueError, match="unknown attack"):
        t_attacks.get_attack("nosuch")
