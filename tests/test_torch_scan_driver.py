"""The port's compiled drivers (``run_dynabro_scan``, ``run_momentum_scan``)
and worker-momentum baseline, on the CPU, against the port's per-round
drivers and against the JAX package.

On the CPU the compiled drivers run each round's function eagerly from the
precomputed schedules, so they are held to the port's per-round drivers
bit for bit: params, round logs and evals, for every class rule and every
attack, under chunking, and at T=0. Against the JAX package (same numpy
inputs as tests/test_torch_main_path.py: params0, index batches, masks) the
tolerances are those of that file: round logs equal, params atol 1e-6. The
host schedules are plain numpy in both packages and must be equal.
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
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import optimizers as t_optim

# ------------------------------------------------------------ a small task
#
# A softmax regression on numpy data: every rule and attack runs both
# drivers at T=12 in a fraction of a second.

TM, T_BYZ, T_RUN = 7, 3, 12
X = np.random.default_rng(0).normal(size=(256, 6)).astype(np.float32)
Y = np.random.default_rng(1).integers(0, 3, size=256)
P0 = {"b": np.zeros(3, np.float32),
      "w": (np.random.default_rng(2).normal(size=(6, 3)) * 0.3).astype(np.float32)}


def _small_task():
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)

    def loss(params, idx):
        logits = Xt[idx] @ params["w"] + params["b"]
        return torch.nn.functional.cross_entropy(logits, Yt[idx])

    def grad_fn(params, idx):
        return torch.func.grad(loss)(params, idx)

    def sampler(t, n):
        g = torch.Generator().manual_seed(1000 + t)
        return torch.randint(0, len(X), (TM, n, 4), generator=g)

    def eval_fn(params, t):
        with torch.no_grad():
            return {"loss": float(loss(params, torch.arange(len(X))))}

    return params_from_numpy(P0, "cpu"), grad_fn, sampler, eval_fn


RULES = {  # rule -> (MLMC option, optimizer): every optimizer's state is carried
    "mean": (1, lambda: t_optim.sgd(0.1)),
    "cwmed": (1, lambda: t_optim.sgd(0.1)),
    "cwtm": (1, lambda: t_optim.sgd(0.1)),
    "krum": (1, lambda: t_optim.momentum(0.05)),
    "geomed": (1, lambda: t_optim.adam(1e-2)),
    "mfm": (2, lambda: t_optim.adagrad_norm(0.5)),
    "nnm+cwtm": (1, lambda: t_optim.sgd(0.1)),
}
ATTACKS = [("none", None), ("sign_flip", None), ("ipm", None), ("alie", None),
           ("alie", {"z": None}), ("random", {"scale": 3.0}), ("shift", None)]


def _small_cfg(rule, attack="sign_flip", kwargs=None, **kw):
    return t_rt.DynaBROConfig(
        mlmc=t_mlmc.MLMCConfig(T=T_RUN, m=TM, V=2.0, option=RULES[rule][0],
                               j_cap=3),
        aggregator=rule, delta=T_BYZ / TM + 1e-3, attack=attack,
        attack_kwargs=kwargs, **kw)


def _switcher():
    return t_switching.get_switcher("periodic", TM, n_byz=T_BYZ, K=3)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _logs(logs):
    return [vars(l) for l in logs]


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("attack,kwargs", ATTACKS,
                         ids=[a + ("-auto_z" if k and "z" in k else "")
                              for a, k in ATTACKS])
def test_scan_equals_per_round_bitwise(rule, attack, kwargs):
    params0, grad_fn, sampler, eval_fn = _small_task()
    cfg, make_opt = _small_cfg(rule, attack, kwargs), RULES[rule][1]
    p1, l1, e1 = t_rt.run_dynabro(grad_fn, params0, make_opt(), cfg,
                                  _switcher(), sampler, T_RUN, seed=2,
                                  eval_fn=eval_fn, eval_every=4)
    p2, l2, e2 = t_rt.run_dynabro_scan(grad_fn, params0, make_opt(), cfg,
                                       _switcher(), sampler, T_RUN, seed=2,
                                       eval_fn=eval_fn, eval_every=4)
    _assert_same(p1, p2)
    assert _logs(l1) == _logs(l2)
    assert len({l.level for l in l1}) > 1
    assert e1 == e2 and [t for t, _ in e1] == [4, 8, 12]


@pytest.mark.parametrize("use_mlmc", [True, False])
def test_scan_chunking_and_eval_invariance(use_mlmc):
    params0, grad_fn, sampler, eval_fn = _small_task()
    cfg = _small_cfg("cwtm", "random", {"scale": 3.0}, use_mlmc=use_mlmc)
    ref = t_rt.run_dynabro(grad_fn, params0, t_optim.sgd(0.1), cfg,
                           _switcher(), sampler, T_RUN, seed=1)
    scan_fn = t_rt.make_dynabro_scan_fn(grad_fn, cfg, t_optim.sgd(0.1))
    for chunk, eval_every in [(0, 0), (5, 0), (1, 0), (0, 5), (4, 3)]:
        p, logs, evals = t_rt.run_dynabro_scan(
            grad_fn, params0, t_optim.sgd(0.1), cfg, _switcher(), sampler,
            T_RUN, seed=1, chunk=chunk, scan_fn=scan_fn,
            eval_fn=eval_fn if eval_every else None, eval_every=eval_every)
        _assert_same(p, ref[0])
        assert _logs(logs) == _logs(ref[1])
        assert [t for t, _ in evals] == (
            list(range(eval_every, T_RUN + 1, eval_every)) if eval_every else [])
    assert ({l.level for l in ref[1]} == {0}) == (not use_mlmc)


def test_scan_zero_rounds():
    params0, grad_fn, sampler, eval_fn = _small_task()
    cfg = _small_cfg("cwtm")
    assert t_rt.run_dynabro_scan(grad_fn, params0, t_optim.sgd(0.1), cfg,
                                 _switcher(), sampler, 0) == (params0, [], [])
    assert t_rt.run_momentum_scan(grad_fn, params0, cfg, _switcher(), sampler,
                                  0, lr=0.1, beta=0.9) == (params0, [])


def test_momentum_scan_equals_per_round_bitwise():
    params0, grad_fn, sampler, eval_fn = _small_task()
    for attack, kwargs in [("shift", {"v": 2.0}), ("random", {"scale": 3.0})]:
        cfg = _small_cfg("cwtm", attack, kwargs)
        sw = lambda: t_switching.get_switcher("momentum_tailored", TM, alpha=0.2)  # noqa: E731
        p1, e1 = t_rt.run_momentum(grad_fn, params0, cfg, sw(), sampler, T_RUN,
                                   lr=0.1, beta=0.9, seed=4, eval_fn=eval_fn,
                                   eval_every=5)
        for chunk in (0, 4):
            p2, e2 = t_rt.run_momentum_scan(grad_fn, params0, cfg, sw(), sampler,
                                            T_RUN, lr=0.1, beta=0.9, seed=4,
                                            eval_fn=eval_fn, eval_every=5,
                                            chunk=chunk)
            _assert_same(p1, p2)
            assert e1 == e2 and [t for t, _ in e1] == [5, 10]


def test_unported_keywords_raise():
    params0, grad_fn, sampler, _ = _small_task()
    cfg = _small_cfg("cwtm")
    opt = t_optim.sgd(0.1)
    # microbatch=, the worker meshes and the GSPMD path are ported
    # (tests/test_torch_zoo.py, tests/test_torch_mesh.py,
    # tests/test_torch_gspmd.py): a (1, 1) (workers, 'model') mesh runs the
    # unsharded round, and param_specs= without a 2-axis mesh raises the
    # JAX package's ValueError
    gspmd = Mesh(("workers", "model"), (1, 1))
    want = t_rt.run_dynabro_scan(grad_fn, params0, opt, cfg, _switcher(),
                                 sampler, 4)[0]
    got = t_rt.run_dynabro_scan(grad_fn, params0, opt, cfg, _switcher(),
                                sampler, 4, mesh=gspmd, param_specs={})[0]
    _assert_same(want, got)
    with pytest.raises(ValueError, match="param_specs"):
        t_rt.run_dynabro_scan(grad_fn, params0, opt, cfg, _switcher(),
                              sampler, 4, param_specs={})
    assert t_rt.make_dynabro_scan_fn(grad_fn, cfg, opt,
                                     mesh=gspmd).worker_mesh == gspmd
    fn = t_rt.make_dynabro_scan_fn(
        grad_fn, cfg, opt, sweep_mesh=Mesh(("lanes", "workers"), (1, 1)))
    assert fn.lane_form().lanes and fn.worker_mesh is None
    # the lane keywords are ported: they build the sweep's lane form
    for kw in ({"lane_attacks": ["none"]}, {"lane_aggregators": ["cwtm"]}):
        fn = t_rt.make_dynabro_scan_fn(grad_fn, cfg, opt, **kw)
        assert fn.lanes
        for name in ("lane_attacks", "lane_aggregators"):
            want = tuple(kw[name]) if name in kw else None
            assert getattr(fn, name) == want, name
    # the momentum drivers take 1-axis meshes only, as the JAX package's
    with pytest.raises(ValueError, match="1-axis"):
        t_rt.make_momentum_scan_fn(grad_fn, cfg, 0.1, 0.9, mesh=gspmd)
    with pytest.raises(ValueError, match="1-axis"):
        t_rt.run_momentum_scan(grad_fn, params0, cfg, _switcher(), sampler, 4,
                               lr=0.1, beta=0.9, mesh=gspmd)


# ------------------------------------------------------------ schedules


def _cfg_pair(use_mlmc, T, j_cap):
    kw = dict(T=T, m=5, V=1.0, j_cap=j_cap)
    return (j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**kw), use_mlmc=use_mlmc),
            t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**kw), use_mlmc=use_mlmc))


@pytest.mark.parametrize("use_mlmc", [True, False])
@pytest.mark.parametrize("T,j_cap,seed", [(1, 7, 0), (12, 3, 1), (150, 5, 0),
                                          (300, 7, 9)])
def test_level_plan_and_logs_equal(use_mlmc, T, j_cap, seed):
    jcfg, tcfg = _cfg_pair(use_mlmc, T, j_cap)
    want = j_rt._level_plan(jcfg, np.random.default_rng(seed), T)
    got = t_rt._level_plan(tcfg, np.random.default_rng(seed), T)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    levels, _, n_max = got
    rng = np.random.default_rng(seed)
    ok = rng.random(T) < 0.7
    masks = rng.random((T, n_max, 5)) < 0.3
    assert (_logs(t_rt._round_logs(levels, ok, masks, tcfg.mlmc.j_max))
            == _logs(j_rt._round_logs(levels, ok, masks, jcfg.mlmc.j_max)))


class _WithinRound:
    """Identities that flip between the computations of a round."""

    def __init__(self, switcher_cls):
        self.cls = switcher_cls

    def make(self):
        class Flipping(self.cls):
            def mask(self, t):
                return np.arange(self.m) < (t % 3)

            def within_round(self, t, k):
                return np.roll(self.mask(t), k)
        return Flipping(6)


@pytest.mark.parametrize("name,kw", [("static", dict(n_byz=2)),
                                     ("periodic", dict(n_byz=3, K=4)),
                                     ("bernoulli", dict(p=0.3, D=2, delta_max=0.4)),
                                     ("within_round", {})])
def test_mask_schedule_equal(name, kw):
    T, n_max = 40, 8
    ns = np.where(np.arange(T) % 3 == 0, 8, 2)
    if name == "within_round":
        jsw, tsw = (_WithinRound(j_switching.Switcher).make(),
                    _WithinRound(t_switching.Switcher).make())
    else:
        jsw = j_switching.get_switcher(name, 6, seed=3, **kw)
        tsw = t_switching.get_switcher(name, 6, seed=3, **kw)
    np.testing.assert_array_equal(t_rt._mask_schedule(tsw, T, n_max, ns),
                                  j_rt._mask_schedule(jsw, T, n_max, ns))


def test_segment_bounds_equal():
    for T in (0, 1, 12, 150):
        for eval_every in (0, 1, 5, 30, 200):
            for chunk in (0, -1, 1, 7, 150):
                assert (t_rt._segment_bounds(T, eval_every, chunk)
                        == j_rt._segment_bounds(T, eval_every, chunk))


def test_pad_units_level_prefix_and_batch_schedule_equal():
    rng = np.random.default_rng(8)
    tree = {"a": rng.normal(size=(3, 2, 5)).astype(np.float32),
            "b": (rng.integers(0, 9, size=(3, 2)),
                  rng.normal(size=(3, 2, 1, 2)).astype(np.float32))}
    jtree = {"a": jnp.asarray(tree["a"]),
             "b": tuple(jnp.asarray(x) for x in tree["b"])}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": tuple(torch.from_numpy(x) for x in tree["b"])}

    def equal(got, want):
        assert np.array_equal(got["a"].numpy(), np.asarray(want["a"]))
        for g, w in zip(got["b"], want["b"]):
            assert np.array_equal(g.numpy(), np.asarray(w))

    for n_max in (2, 8):
        padded = t_rt._pad_units(ttree, n_max, axis=1)
        equal(padded, j_rt._pad_units(jtree, n_max, axis=1))
        for n in (1, 2, n_max):
            if n <= n_max:
                equal(t_mlmc.level_prefix(padded, n, n_max, axis=1),
                      j_mlmc.level_prefix(j_rt._pad_units(jtree, n_max, axis=1),
                                          n, n_max, axis=1))
    m = 3

    def np_sampler(t, n):
        return np.random.default_rng(t).normal(size=(m, n, 2)).astype(np.float32)

    tn = [(0, 1), (1, 4), (2, 2), (3, 8)]
    want = j_rt._batch_schedule(lambda t, n: jnp.asarray(np_sampler(t, n)), tn,
                                8, vectorize=False)
    got = t_rt._batch_schedule(lambda t, n: torch.from_numpy(np_sampler(t, n)),
                               tn, 8)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ against JAX

M, N_BYZ = 17, 8
DELTA = N_BYZ / M + 1e-3


@pytest.fixture(scope="module")
def jax_task():
    return j_clf.make_task(M, seed=0)


@pytest.fixture(scope="module")
def torch_task():
    return t_clf.make_task(M, seed=0, device="cpu")


def _indices(jax_task, t, n):
    return np.array(jax_task[2](t, n))


def _close(got_torch, want_jax, atol=1e-6):
    got = params_to_numpy(got_torch)
    for k in sorted(want_jax):
        np.testing.assert_allclose(got[k], np.asarray(want_jax[k]), rtol=0,
                                   atol=atol, err_msg=k)


def test_dynabro_scan_matches_jax_scan(jax_task, torch_task):
    """A T=12 replay of the JAX package's compiled driver (CWTM, sign_flip,
    Periodic(10), MLMC T=12 so j_max = 3) on the JAX index batches."""
    kw = dict(aggregator="cwtm", delta=DELTA, attack="sign_flip")
    mlmc_kw = dict(T=12, m=M, V=5.0, kappa=1.0, j_cap=5)
    jcfg = j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**mlmc_kw),
                              agg_backend="ref", **kw)
    tcfg = t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**mlmc_kw), **kw)
    jp, jlogs, jevals = j_rt.run_dynabro_scan(
        jax_task[1], jax_task[0], j_optim.sgd(0.1), jcfg,
        j_switching.get_switcher("periodic", M, n_byz=N_BYZ, K=10),
        lambda t, n: jnp.asarray(_indices(jax_task, t, n)), 12, seed=0,
        eval_fn=jax_task[3], eval_every=6, vectorize_batches=False)
    tp, tlogs, tevals = t_rt.run_dynabro_scan(
        torch_task[1], params_from_numpy(jax_task[0], "cpu"), t_optim.sgd(0.1),
        tcfg, t_switching.get_switcher("periodic", M, n_byz=N_BYZ, K=10),
        lambda t, n: torch.from_numpy(_indices(jax_task, t, n)).long(), 12,
        seed=0, eval_fn=torch_task[3], eval_every=6, vectorize_batches=False)
    assert _logs(tlogs) == _logs(jlogs)
    assert len({l.level for l in tlogs}) > 1
    _close(tp, jp)
    assert [t for t, _ in tevals] == [t for t, _ in jevals] == [6, 12]
    for (_, a), (_, b) in zip(tevals, jevals):
        assert a["test_acc"] == pytest.approx(b["test_acc"], abs=1e-3)


def test_momentum_mlp_matches_jax(jax_task, torch_task):
    """App. E's comparison on the MLP at m=17: momentum_tailored(α = 0.1),
    shift (v=1), CWTM at δ = 8/17 + 1e-3, β = 0.9, lr = 0.1, T=12."""
    kw = dict(aggregator="cwtm", delta=DELTA, attack="shift",
              attack_kwargs={"v": 1.0})
    mlmc_kw = dict(T=150, m=M, V=5.0, kappa=1.0, j_cap=5)
    jcfg = j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**mlmc_kw),
                              agg_backend="ref", **kw)
    tcfg = t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**mlmc_kw), **kw)
    jp, _ = j_rt.run_momentum(
        jax_task[1], jax_task[0], jcfg,
        j_switching.get_switcher("momentum_tailored", M, alpha=0.1),
        jax_task[2], 12, lr=0.1, beta=0.9)
    sampler = lambda t, n: torch.from_numpy(_indices(jax_task, t, n)).long()  # noqa: E731
    runs = [driver(torch_task[1], params_from_numpy(jax_task[0], "cpu"), tcfg,
                   t_switching.get_switcher("momentum_tailored", M, alpha=0.1),
                   sampler, 12, lr=0.1, beta=0.9)
            for driver in (t_rt.run_momentum, t_rt.run_momentum_scan)]
    _close(runs[0][0], jp)
    _assert_same(runs[0][0], runs[1][0])


A = np.array([[2.0, 1.0], [1.0, 2.0]], np.float32)
SIGMA = 0.5


def _noise(m):
    def sample(t, n):
        return np.random.default_rng(500 + t).normal(size=(m, n, 2)).astype(np.float32)
    return sample


@pytest.mark.parametrize("alpha,v,beta", [(0.05, 3.0, 0.95), (0.1, 1.0, 0.9)])
def test_momentum_quadratic_matches_jax(alpha, v, beta):
    """App. E's 2-d quadratic f(x) = ½ xᵀAx at m=3 under momentum_tailored
    and shift, CWMed, with the gradient noise fed in as numpy batches."""
    m, T = 3, 60
    kw = dict(aggregator="cwmed", attack="shift", attack_kwargs={"v": v})
    mlmc_kw = dict(T=T, m=m, V=4 * SIGMA + 1, kappa=1.0)
    jcfg = j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**mlmc_kw),
                              agg_backend="ref", **kw)
    tcfg = t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**mlmc_kw), **kw)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    x0 = {"x": np.array([3.0, -2.0], np.float32)}
    jp, _ = j_rt.run_momentum(
        lambda p, e: {"x": Aj @ p["x"] + SIGMA * e},
        {"x": jnp.asarray(x0["x"])}, jcfg,
        j_switching.get_switcher("momentum_tailored", m, alpha=alpha),
        lambda t, n: jnp.asarray(_noise(m)(t, n)), T, lr=2e-2, beta=beta)
    runs = [driver(lambda p, e: {"x": At @ p["x"] + SIGMA * e},
                   params_from_numpy(x0, "cpu"), tcfg,
                   t_switching.get_switcher("momentum_tailored", m, alpha=alpha),
                   lambda t, n: torch.from_numpy(_noise(m)(t, n)), T, lr=2e-2,
                   beta=beta)
            for driver in (t_rt.run_momentum, t_rt.run_momentum_scan)]
    _close(runs[0][0], jp)
    _assert_same(runs[0][0], runs[1][0])
    assert float(np.abs(params_to_numpy(runs[0][0])["x"]).max()) < 3.0
