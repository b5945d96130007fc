"""The port's training path against the JAX package's on the paper's
Figure-1 setting: m=17 workers, 8 Byzantine, sign_flip under Periodic(10),
CWTM with δ = 8/17 + 1e-3 (trim 8), MLMC T=150 / V=5 / j_cap=5, sgd(0.1),
on the Gaussian-mixture MLP.

Both packages get the same inputs through numpy: the JAX package's params0
(``init_clf``), its index sampler's batches, and the masks of the (numpy,
bitwise-equal) switchers. Tolerances:

  * per-unit gradients: rtol 1e-5, atol 1e-6 (float32 matmul/tanh/softmax in
    another framework);
  * one step per level: params atol 1e-6; ``corr_norm`` rtol 1e-4 (a norm of
    a difference of level means, where the ulp noise of the means is
    amplified); ``failsafe_ok`` equal;
  * the T=12 run: round logs equal; params atol 1e-6 (twelve sgd steps of
    that per-step noise; about 6e-8 is seen).
"""
import jax
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
MLMC_KW = dict(T=T, m=M, V=5.0, option=1, kappa=1.0, j_cap=5)


@pytest.fixture(scope="module")
def jax_task():
    return j_clf.make_task(M, seed=0)


@pytest.fixture(scope="module")
def torch_task():
    return t_clf.make_task(M, seed=0, device="cpu")


@pytest.fixture(scope="module")
def jax_step(jax_task):
    cfg = j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**MLMC_KW),
                             aggregator="cwtm", delta=DELTA, attack="sign_flip",
                             agg_backend="ref")
    return cfg, j_rt.make_dynabro_step(jax_task[1], cfg, j_optim.sgd(0.1))


def _torch_cfg(backend="auto"):
    return t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**MLMC_KW),
                              aggregator="cwtm", delta=DELTA,
                              attack="sign_flip", agg_backend=backend)


def _indices(jax_task, t, n):
    return np.array(jax_task[2](t, n))


def _close(got_torch, want_jax, **tol):
    got = params_to_numpy(got_torch)
    for k in sorted(want_jax):
        np.testing.assert_allclose(got[k], np.asarray(want_jax[k]), err_msg=k,
                                   **tol)


def test_grad_fn_on_one_unit_batch(jax_task, torch_task):
    idx = np.arange(19968, 20000)  # the last unit batch of the training split
    gj = jax_task[1](jax_task[0], jnp.asarray(idx))
    gt = torch_task[1](params_from_numpy(jax_task[0], "cpu"),
                       torch.from_numpy(idx))
    _close(gt, gj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 4])
def test_per_unit_grads(jax_task, torch_task, n):
    idx = _indices(jax_task, 3, n)  # (m, n, unit_batch)
    want = j_rt._per_worker_grads(jax_task[1], jax_task[0], jnp.asarray(idx))
    got = t_rt._per_worker_grads(torch_task[1],
                                 params_from_numpy(jax_task[0], "cpu"),
                                 torch.from_numpy(idx).long())
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("j", [1, 2, 3, 4, 5, 6])
def test_one_step_per_level(jax_task, torch_task, jax_step, j):
    jcfg, step = jax_step
    n = 2 ** j if j <= jcfg.mlmc.j_max else 1
    idx = _indices(jax_task, 40 + j, n)
    sw = j_switching.get_switcher("periodic", M, n_byz=N_BYZ, K=10)
    masks = np.stack([sw.within_round(40 + j, k) for k in range(n)])
    opt = j_optim.sgd(0.1)
    jp, _, jinfo = step(jax_task[0], opt.init(jax_task[0]), jnp.asarray(idx),
                        jnp.asarray(masks), jax.random.PRNGKey(0), j)
    tparams = params_from_numpy(jax_task[0], "cpu")
    topt = t_optim.sgd(0.1)
    tstep = t_rt.make_dynabro_step(torch_task[1], _torch_cfg(), topt)
    tp, _, tinfo = tstep(tparams, topt.init(tparams),
                         torch.from_numpy(idx).long(), torch.from_numpy(masks), j)
    _close(tp, jp, rtol=0, atol=1e-6)
    assert bool(tinfo["failsafe_ok"]) == bool(jinfo["failsafe_ok"])
    assert tinfo["level"] == jinfo["level"] == j
    np.testing.assert_allclose(float(tinfo["corr_norm"]),
                               float(jinfo["corr_norm"]), rtol=1e-4)


def test_run_dynabro_matches_jax(jax_task, torch_task, jax_step):
    jcfg, step = jax_step
    T_run = 12
    jp, jlogs, _ = j_rt.run_dynabro(
        jax_task[1], jax_task[0], j_optim.sgd(0.1), jcfg,
        j_switching.get_switcher("periodic", M, n_byz=N_BYZ, K=10),
        jax_task[2], T_run, seed=0, step=step)
    tp, tlogs, tevals = t_rt.run_dynabro(
        torch_task[1], params_from_numpy(jax_task[0], "cpu"), t_optim.sgd(0.1),
        _torch_cfg(), t_switching.get_switcher("periodic", M, n_byz=N_BYZ, K=10),
        lambda t, n: torch.from_numpy(_indices(jax_task, t, n)).long(),
        T_run, seed=0, eval_fn=torch_task[3], eval_every=6)
    assert [vars(l) for l in tlogs] == [vars(l) for l in jlogs]
    assert len({l.level for l in tlogs}) > 1
    _close(tp, jp, rtol=0, atol=1e-6)
    assert [t for t, _ in tevals] == [6, 12]
    acc = tevals[-1][1]["test_acc"]
    assert acc == pytest.approx(jax_task[3](jp, T_run - 1)["test_acc"], abs=1e-3)


def test_plain_robust_sgd_matches_jax(jax_task, torch_task):
    """use_mlmc=False: one unit batch a round, its aggregate is the step."""
    kw = dict(aggregator="cwmed", delta=DELTA, attack="sign_flip",
              use_mlmc=False)
    jcfg = j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**MLMC_KW),
                              agg_backend="ref", **kw)
    tcfg = t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**MLMC_KW), **kw)
    jp, jlogs, _ = j_rt.run_dynabro(
        jax_task[1], jax_task[0], j_optim.sgd(0.1), jcfg,
        j_switching.get_switcher("static", M, n_byz=N_BYZ), jax_task[2], 4)
    tp, tlogs, _ = t_rt.run_dynabro(
        torch_task[1], params_from_numpy(jax_task[0], "cpu"), t_optim.sgd(0.1),
        tcfg, t_switching.get_switcher("static", M, n_byz=N_BYZ),
        lambda t, n: torch.from_numpy(_indices(jax_task, t, n)).long(), 4)
    assert [vars(l) for l in tlogs] == [vars(l) for l in jlogs]
    assert {l.level for l in tlogs} == {0}
    _close(tp, jp, rtol=0, atol=1e-6)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_clf.make_task(M)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
