"""The port's model-zoo path on the CPU: ``SyntheticLMData``,
``make_zoo_task`` / ``task_for_config`` and the compiled driver's
``microbatch=True`` streaming (``run_dynabro_scan``, ``Session``), against
the JAX package's zoo driver and against the port's own stacked path.

Tolerances: a T=8 replay of the JAX package's ``run_dynabro_scan(
make_zoo_task("smollm-360m", ...), microbatch=True)`` on the JAX weights and
batches passed through numpy holds equal round logs and params at rtol
1e-5, atol 1e-6 a leaf (float32 rounding of eight rounds' updates; measured
at most 1.2e-7 absolute); the streamed path against the stacked one in the
port, at rtol 1e-5, atol 1e-6 (the level means summed in another order);
``Session`` against ``run_dynabro_scan``, bitwise.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.data import pipeline as j_pipeline
from repro.models import zoo as j_zoo
from repro.optim import optimizers as j_optim
from repro_torch.api import session as t_session
from repro_torch.configs import get_reduced_config
from repro_torch.convert import zoo_params_from_numpy
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching
from repro_torch.data import SyntheticLMData
from repro_torch.models import make_zoo_task, task_for_config
from repro_torch.optim import optimizers as t_optim

TOL = dict(rtol=1e-5, atol=1e-6)
M, T, SEQ, D = 4, 8, 8, 32


def _cfg(pkg, attack="sign_flip", T=T):
    mlmc, rt = (j_mlmc, j_rt) if pkg == "jax" else (t_mlmc, t_rt)
    return rt.DynaBROConfig(
        mlmc=mlmc.MLMCConfig(T=T, m=M, V=3.0, kappa=1.0, j_cap=2),
        aggregator="cwtm", delta=0.3, attack=attack)


def _switcher(pkg):
    sw = j_switching if pkg == "jax" else t_switching
    return sw.get_switcher("periodic", M, n_byz=1, K=2)


def _logs(logs):
    return [vars(l) for l in logs]


@pytest.fixture(scope="module")
def task():
    return make_zoo_task("smollm-360m", seq_len=SEQ, d_model=D, device="cpu")[0]


def _run(task, microbatch=True, attack="sign_flip", **kw):
    return t_rt.run_dynabro_scan(
        task.grad_fn, task.params0, t_optim.sgd(0.05), _cfg("torch", attack),
        _switcher("torch"), task.make_sampler(M), T, seed=3,
        microbatch=microbatch, **kw)


# ------------------------------------------------------------ the data


def test_synthetic_lm_batches_shapes_range_and_labels():
    data = SyntheticLMData(vocab_size=97, seq_len=12, global_batch=3, seed=5,
                           device="cpu")
    b = data.batch(7)
    assert b["tokens"].shape == (3, 12) and b["tokens"].dtype == torch.int64
    w = data.worker_batch(7, 2, 5)
    u = data.mlmc_batches(7, 4, 3, 2)
    assert w["tokens"].shape == (5, 12)
    assert u["tokens"].shape == u["labels"].shape == (4, 3, 2, 12)
    for toks, labels, axis in ((b["tokens"], b["labels"], 1),
                               (w["tokens"], w["labels"], 1),
                               (u["tokens"], u["labels"], 3)):
        assert int(toks.min()) >= 0 and int(toks.max()) < 97
        assert torch.equal(labels, torch.roll(toks, -1, axis))
    assert torch.equal(data.batch(7)["tokens"], b["tokens"])  # a pure function
    assert not torch.equal(data.batch(8)["tokens"], b["tokens"])
    assert not torch.equal(u["tokens"][0], u["tokens"][1])  # workers differ
    with pytest.raises(ValueError, match="positive"):
        data.batch(0, 0)
    with pytest.raises(ValueError, match="positive"):
        data.mlmc_batches(0, 2, 2, 0)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_synthetic_lm_mlmc_prefix_property(n):
    """The level-(j−1) batch is the prefix of the level-j one: unit (w, k)
    depends only on (seed, step, w, k)."""
    data = SyntheticLMData(vocab_size=50, seq_len=6, global_batch=1, seed=1,
                           device="cpu")
    full = data.mlmc_sampler(3, unit_batch=2)(4, n)
    half = data.mlmc_sampler(3, unit_batch=2)(4, n // 2)
    for key in ("tokens", "labels"):
        assert torch.equal(full[key][:, : n // 2], half[key])


def test_synthetic_lm_marginals_match_jax():
    """The same marginal distribution as the JAX package's stream (squared
    uniform base, a 0.3 copy of the previous position): mean token and the
    share of positions equal to their predecessor, over 64 x 256 tokens of
    each, within 5 standard errors."""
    V, S, B = 200, 256, 64
    t = SyntheticLMData(V, S, B, seed=0, device="cpu").batch(1)["tokens"].numpy()
    j = np.asarray(j_pipeline.SyntheticLMData(V, S, B, seed=0).batch(1)["tokens"])
    n = t.size
    for stat, sd in ((lambda a: a.mean() / V, 0.3 / np.sqrt(n)),
                     (lambda a: (a[:, 1:] == a[:, :-1]).mean(), 0.5 / np.sqrt(n))):
        assert abs(stat(t) - stat(j)) < 5 * sd, (stat(t), stat(j))
    # squared uniform: half the base tokens lie below V/4
    assert abs((t < V / 4).mean() - 0.5) < 5 * 0.5 / np.sqrt(n)


# ------------------------------------------------------------ the task


def test_make_zoo_task_is_task_for_config_of_the_reduced_config():
    task, cfg = make_zoo_task("qwen3-0.6b", seq_len=SEQ, d_model=D, device="cpu")
    assert cfg == get_reduced_config("qwen3-0.6b", d_model=D, n_layers=2)
    other = task_for_config(cfg, seq_len=SEQ, device="cpu")
    assert all(torch.equal(task.params0[k], other.params0[k])
               for k in task.params0)
    b1, b2 = task.make_sampler(M)(2, 4), other.make_sampler(M)(2, 4)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert task.objective(task.params0) == other.objective(other.params0)
    g = task.grad_fn(task.params0, {k: v[0, 0] for k, v in b1.items()})
    assert sorted(g) == sorted(task.params0)


def test_make_zoo_task_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_zoo_task("smollm-360m", d_model=D)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLMData(10, 4, 1).batch(0)


# ------------------------------------------------------------ the JAX replay


@pytest.fixture(scope="module")
def jax_replay():
    """The JAX package's zoo driver, T=8, microbatch=True, and the port's
    run of the same weights, batches, levels and masks."""
    jtask, jcfg = j_zoo.make_zoo_task("smollm-360m", seq_len=SEQ, d_model=D)
    jp, jl, _ = j_rt.run_dynabro_scan(
        jtask.grad_fn, jtask.params0, j_optim.sgd(0.05), _cfg("jax"),
        _switcher("jax"), jtask.make_sampler(M), T, seed=3, microbatch=True)
    ttask = task_for_config(get_reduced_config("smollm-360m", d_model=D,
                                               n_layers=2),
                            seq_len=SEQ, device="cpu")
    jsample = jtask.make_sampler(M)

    def sample(t, n):
        return {k: torch.from_numpy(np.array(v)) for k, v in jsample(t, n).items()}

    p0 = zoo_params_from_numpy(jax.tree.map(np.array, jtask.params0), "cpu")
    tp, tl, _ = t_rt.run_dynabro_scan(
        ttask.grad_fn, p0, t_optim.sgd(0.05), _cfg("torch"), _switcher("torch"),
        sample, T, seed=3, microbatch=True)
    want = zoo_params_from_numpy(jax.tree.map(np.array, jp), "cpu")
    return (tp, tl), (want, jl)


def test_microbatch_replays_jax_round_logs(jax_replay):
    (_, tl), (_, jl) = jax_replay
    assert _logs(tl) == _logs(jl)
    assert {l.level for l in tl} >= {1, 3}  # in the cap and beyond it


@pytest.mark.parametrize("leaf", ["embed", "final_norm/scale",
                                  "blocks/b0/mix/wq", "blocks/b0/mix/wo",
                                  "blocks/b0/mlp/dense/w2"])
def test_microbatch_replays_jax_params(jax_replay, leaf):
    (tp, _), (want, _) = jax_replay
    assert sorted(tp) == sorted(want)
    np.testing.assert_allclose(tp[leaf].numpy(), want[leaf].numpy(), **TOL)


def test_microbatch_replays_jax_every_leaf(jax_replay):
    (tp, _), (want, _) = jax_replay
    for k in want:
        np.testing.assert_allclose(tp[k].numpy(), want[k].numpy(), err_msg=k,
                                   **TOL)


# ------------------------------------------------------------ the port's paths


def test_microbatch_against_the_stacked_path(task):
    p1, l1, _ = _run(task, microbatch=True)
    p2, l2, _ = _run(task, microbatch=False)
    assert _logs(l1) == _logs(l2)
    for k in p1:
        np.testing.assert_allclose(p1[k].numpy(), p2[k].numpy(), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("attack", ["sign_flip", "random"])
def test_session_microbatch_is_run_dynabro_scan(task, attack):
    """``Session(microbatch=True)``: ``run`` and ``step`` round by round,
    bitwise equal to ``run_dynabro_scan(microbatch=True)``; ``random``
    draws unit by unit from the run's generator."""
    p1, l1, _ = _run(task, attack=attack)
    sess = t_session.build_session(_cfg("torch", attack), task, opt=t_optim.sgd(0.05),
                                   switcher=_switcher("torch"), seed=3,
                                   microbatch=True)
    assert sess.scan_fn.microbatch
    p2, l2, _ = sess.run(T)
    assert _logs(l1) == _logs(l2)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    carry, sched = sess.init_carry(), sess.schedule(T)
    for t in range(T):
        carry, info = sess.step(carry, sess.round_inputs(sched, t))
        assert info.failsafe_ok == l1[t].failsafe_ok
    assert all(torch.equal(p1[k], carry[0][k]) for k in p1)
    if attack == "random":
        p3, _, _ = _run(task, attack="sign_flip")
        assert not torch.equal(p1["embed"], p3["embed"])


def test_corr_norms_of_a_run(task):
    """``ScanFn.corr_norms``: the run's correction norms, 0 beyond the cap,
    the same on a rerun."""
    scan_fn = t_rt.make_dynabro_scan_fn(task.grad_fn, _cfg("torch"),
                                        t_optim.sgd(0.05), microbatch=True)
    _, logs, _ = _run(task, scan_fn=scan_fn)
    first = scan_fn.corr_norms.copy()
    assert first.shape == (T,)
    j_max = _cfg("torch").mlmc.j_max
    for log, dn in zip(logs, first):
        assert (dn == 0.0) == (log.level > j_max)
    _run(task, scan_fn=scan_fn)
    np.testing.assert_array_equal(scan_fn.corr_norms, first)


def test_microbatch_scan_fn_checks():
    """A prebuilt scan_fn built for the other unit path, and the lane forms
    with microbatch, raise the JAX package's errors."""
    task, _ = make_zoo_task("smollm-360m", seq_len=SEQ, d_model=D, device="cpu")
    cfg, opt = _cfg("torch"), t_optim.sgd(0.05)
    fn = t_rt.make_dynabro_scan_fn(task.grad_fn, cfg, opt, microbatch=True)
    with pytest.raises(ValueError, match="microbatch"):
        _run(task, microbatch=False, scan_fn=fn)
    stacked = t_rt.make_dynabro_scan_fn(task.grad_fn, cfg, opt)
    with pytest.raises(ValueError, match="microbatch"):
        _run(task, microbatch=True, scan_fn=stacked)
    with pytest.raises(ValueError, match="microbatch"):
        t_session.Session(cfg, grad_fn=task.grad_fn, params0=task.params0,
                          opt=opt, scan_fn=stacked, microbatch=True)
    for kw in ({"lane_attacks": ["none"]}, {"lane_aggregators": ["cwtm"]}):
        with pytest.raises(ValueError, match="lane-batched sweep"):
            t_rt.make_dynabro_scan_fn(task.grad_fn, cfg, opt, microbatch=True,
                                      **kw)
    # param_specs= without a (workers, 'model') mesh: the JAX package's error
    with pytest.raises(ValueError, match="param_specs"):
        _run(task, param_specs={})


def test_microbatch_plain_sgd_and_t0(task):
    """``use_mlmc=False`` (one unit a round, aggregated as the full-batch
    mean) and T=0 through the streamed path."""
    cfg = dataclasses.replace(_cfg("torch"), use_mlmc=False)
    args = (task.grad_fn, task.params0, t_optim.sgd(0.05), cfg,
            _switcher("torch"), task.make_sampler(M))
    p1, l1, _ = t_rt.run_dynabro_scan(*args, 4, seed=1, microbatch=True)
    p2, l2, _ = t_rt.run_dynabro_scan(*args, 4, seed=1)
    assert _logs(l1) == _logs(l2) and {l.level for l in l1} == {0}
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    p0, logs, evals = t_rt.run_dynabro_scan(*args, 0, microbatch=True)
    assert p0 is task.params0 and logs == [] and evals == []
