"""The port's ``Session`` facade on the CPU: its schedules against the JAX
package's ``Session.schedule``; ``step`` driven round by round bitwise
equal to ``run`` (``random`` included, whose generator state rides in the
carry); ``driver="legacy"`` equal to the per-round drivers; momentum mode;
``run`` against the JAX package's on the same numpy inputs (round logs
equal, params within 1e-6); and the keywords that are refused."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_tasks import jax_softmax, logs_of, to_numpy, torch_softmax
from repro.api import session as j_session
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.optim import optimizers as j_optim
from repro_torch.api import session as t_session
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import optimizers as t_optim

M, T, SEED = 7, 12, 3


def _cfg(pkg, **kw):
    mlmc = (t_mlmc if pkg == "torch" else j_mlmc).MLMCConfig(T=T, m=M, V=2.0,
                                                            j_cap=3)
    rt = t_rt if pkg == "torch" else j_rt
    base = dict(aggregator="cwtm", delta=3 / M + 1e-3, attack="sign_flip")
    base.update(kw)
    return rt.DynaBROConfig(mlmc=mlmc, **base)


def _switcher(pkg, name="periodic", **kw):
    kw = kw or {"n_byz": 3, "K": 4}
    return (t_switching if pkg == "torch" else j_switching).get_switcher(
        name, M, seed=SEED, **kw)


def _session(mode="dynabro", opt=None, **cfg_kw):
    task = torch_softmax()
    kw = dict(opt=opt or t_optim.adagrad_norm(0.5)) if mode == "dynabro" \
        else dict(lr=0.1, beta=0.9)
    sw = _switcher("torch") if mode == "dynabro" else _switcher(
        "torch", "momentum_tailored", alpha=0.25)
    return t_session.build_session(_cfg("torch", **cfg_kw), task, switcher=sw,
                                   seed=SEED, mode=mode, **kw)


def _same(a, b):
    assert sorted(a) == sorted(b)
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mode", ["dynabro", "momentum"])
def test_schedule_equals_jax(mode):
    t_sess = _session(mode)
    jt = jax_softmax()
    jkw = dict(opt=j_optim.sgd(0.1)) if mode == "dynabro" else dict(lr=0.1,
                                                                     beta=0.9)
    jsw = _switcher("jax") if mode == "dynabro" else _switcher(
        "jax", "momentum_tailored", alpha=0.25)
    j_sess = j_session.build_session(_cfg("jax"), jt, switcher=jsw, seed=SEED,
                                     mode=mode, **jkw)
    for T_ in (1, T, 40):
        a, b = t_sess.schedule(T_), j_sess.schedule(T_)
        assert (a.T, a.n_max) == (b.T, b.n_max)
        for f in ("levels", "ns", "masks"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert a.keys.shape == (T_, 2) and a.keys.dtype == np.int64
        np.testing.assert_array_equal(a.keys[:, 1], np.arange(T_))
        assert (a.keys[:, 0] == SEED * (100_003 if mode == "dynabro"
                                        else 77_003)).all()
        assert t_sess.schedule(T_) is a  # cached


CASES = [("sign_flip", None, "cwtm"), ("random", {"scale": 3.0}, "cwtm"),
         ("random", {"scale": 3.0}, "krum"), ("alie", None, "nnm+cwtm")]


@pytest.mark.parametrize("attack,kwargs,rule", CASES,
                         ids=[f"{a}-{r}" for a, _, r in CASES])
def test_steps_equal_run_bitwise(attack, kwargs, rule):
    sess = _session(attack=attack, attack_kwargs=kwargs, aggregator=rule)
    p_run, logs, _ = sess.run(T)
    p_scan, logs_scan, _ = t_rt.run_dynabro_scan(
        sess.grad_fn, sess.params0, t_optim.adagrad_norm(0.5), sess.cfg,
        _switcher("torch"), sess.sample_batches, T, seed=SEED)
    assert _same(p_run, p_scan) and logs_of(logs) == logs_of(logs_scan)
    carry = sess.init_carry()
    assert len(carry) == (3 if attack == "random" else 2)
    sched = sess.schedule(T)
    infos = []
    for t in range(T):
        carry, info = sess.step(carry, sess.round_inputs(sched, t))
        infos.append(info)
    assert _same(carry[0], p_run)
    assert [i.failsafe_ok for i in infos] == [l.failsafe_ok for l in logs]
    assert all(isinstance(i.corr_norm, float) for i in infos)


def test_legacy_driver_is_the_per_round_driver():
    sess = _session(attack="random", attack_kwargs={"scale": 2.0})
    p1, l1, e1 = sess.run(T, driver="legacy", eval_fn=lambda p, t: {"t": t},
                          eval_every=4)
    p2, l2, e2 = t_rt.run_dynabro(sess.grad_fn, sess.params0,
                                  t_optim.adagrad_norm(0.5), sess.cfg,
                                  _switcher("torch"), sess.sample_batches, T,
                                  seed=SEED, eval_fn=lambda p, t: {"t": t},
                                  eval_every=4)
    assert _same(p1, p2) and logs_of(l1) == logs_of(l2) and e1 == e2
    p3, l3, e3 = sess.run(T, eval_fn=lambda p, t: {"t": t}, eval_every=4)
    assert _same(p1, p3) and logs_of(l1) == logs_of(l3) and e1 == e3
    with pytest.raises(ValueError, match="unknown driver"):
        sess.run(T, driver="nope")


@pytest.mark.parametrize("attack", ["shift", "random"])
def test_momentum_session(attack):
    sess = _session("momentum", attack=attack)
    p_run, evals = sess.run(T)
    assert evals == []
    p_leg, _ = sess.run(T, driver="legacy")
    assert _same(p_run, p_leg)
    p_scan, _ = t_rt.run_momentum_scan(
        sess.grad_fn, sess.params0, sess.cfg,
        _switcher("torch", "momentum_tailored", alpha=0.25),
        sess.sample_batches, T, lr=0.1, beta=0.9, seed=SEED)
    assert _same(p_run, p_scan)
    carry = sess.init_carry()
    sched = sess.schedule(T)
    for t in range(T):
        carry, info = sess.step(carry, sess.round_inputs(sched, t))
        assert info.failsafe_ok is None and info.corr_norm is None
    assert _same(carry[0], p_run)
    assert carry[1]["w"].shape == (M,) + p_run["w"].shape


def test_run_equals_jax_session_run():
    tt, jt = torch_softmax(), jax_softmax()
    t_sess = t_session.build_session(_cfg("torch"), tt, switcher=_switcher("torch"),
                                     seed=SEED, opt=t_optim.sgd(0.1))
    j_sess = j_session.build_session(_cfg("jax"), jt, switcher=_switcher("jax"),
                                     seed=SEED, opt=j_optim.sgd(0.1),
                                     vectorize_batches=False)
    p_t, l_t, _ = t_sess.run(T)
    p_j, l_j, _ = j_sess.run(T)
    assert logs_of(l_t) == logs_of(l_j)
    want = to_numpy(p_j)
    for k in want:
        np.testing.assert_allclose(p_t[k].numpy(), want[k], rtol=0, atol=1e-6)


def test_session_errors_and_unported_keywords(monkeypatch):
    task = torch_softmax()
    cfg = _cfg("torch")
    with pytest.raises(ValueError, match="unknown session mode"):
        t_session.Session(cfg, grad_fn=None, params0=None, mode="x")
    with pytest.raises(ValueError, match="opt="):
        t_session.Session(cfg, grad_fn=None, params0=None)
    with pytest.raises(ValueError, match="lr= and beta="):
        t_session.Session(cfg, grad_fn=None, params0=None, mode="momentum")
    base = dict(grad_fn=task.grad_fn, params0=task.params0, opt=t_optim.sgd(0.1))
    # microbatch=, the worker mesh= and the GSPMD path are ported
    # (tests/test_torch_zoo.py, tests/test_torch_mesh.py,
    # tests/test_torch_gspmd.py): param_specs= without a 2-axis mesh raises
    # the JAX package's ValueError; guard_recompiles= and its env var build
    # a guarded session (tests/test_torch_lint.py)
    sess = t_session.Session(cfg, **base, m=M, param_specs={},
                             mesh=Mesh(("workers", "model"), (1, 1)))
    assert sess.scan_fn.worker_mesh == Mesh(("workers", "model"), (1, 1))
    with pytest.raises(ValueError, match="param_specs"):
        t_session.Session(cfg, **base, param_specs={})
    assert t_session.Session(cfg, **base, guard_recompiles=True).guard_recompiles
    with pytest.raises(ValueError, match="worker count"):
        t_session.Session(cfg, **base, mesh=Mesh(("workers",), (1,)))
    monkeypatch.setenv(t_session.GUARD_ENV, "1")
    assert t_session.Session(cfg, **base).guard_recompiles
    monkeypatch.delenv(t_session.GUARD_ENV)
    assert not t_session.Session(cfg, **base).guard_recompiles
    lane_fn = t_rt.make_dynabro_scan_fn(task.grad_fn, cfg, t_optim.sgd(0.1),
                                        lane_aggregators=("cwtm",))
    with pytest.raises(ValueError, match="run_dynabro_scan_sweep"):
        t_session.Session(cfg, **base, scan_fn=lane_fn)
    with pytest.raises(ValueError, match="switcher"):
        t_session.Session(cfg, **base).schedule(4)
    sess = t_session.build_session(cfg, task, switcher=_switcher("torch"),
                                   opt=t_optim.sgd(0.1))
    assert sess.m == M and sess.sampler_factory is not None
    assert sess.run(0) == (task.params0, [], [])


def test_nan_tripwire():
    task = torch_softmax()
    bad = dict(task.params0, b=torch.full((3,), float("nan")))
    sess = t_session.build_session(_cfg("torch"), dataclasses.replace(
        task, params0=bad), switcher=_switcher("torch"), opt=t_optim.sgd(0.1),
        nan_tripwire=True)
    with pytest.raises(FloatingPointError, match="non-finite"):
        sess.step(sess.init_carry(), sess.round_inputs(sess.schedule(T), 0))
    with pytest.raises(FloatingPointError, match="non-finite"):
        sess.run(2)
    off = t_session.build_session(_cfg("torch"), dataclasses.replace(
        task, params0=bad), switcher=_switcher("torch"), opt=t_optim.sgd(0.1))
    off.run(2)  # off by default: no read, no raise
