"""The port's lane-batched sweep against the JAX package's
``run_dynabro_scan_sweep`` / ``Session.sweep`` on the same numpy inputs
(round logs equal, params within 1e-5): mixed rules with per-lane attacks
and per-lane δ, and replicate seeds."""
import numpy as np
import torch

from _torch_tasks import jax_softmax, logs_of, to_numpy, torch_softmax
from repro.api import specs as j_specs
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.optim import optimizers as j_optim
from repro_torch.api import specs as t_specs
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching
from repro_torch.optim import optimizers as t_optim
from test_torch_sweep import M, SEED, T, _cfgs, _sessions, _switchers

JAX_ATTACKS = ["sign_flip", ("ipm", {"eps": 0.3}), ("alie", {"z": None}),
               ("shift", {"v": 0.5}), ("sign_flip", {"scale": 2.0}), "ipm"]
JAX_AGGS = [("cwtm", {"delta": 0.3}), ("cwtm", {"delta": 0.45}), "krum",
            ("nnm+cwtm", {"delta": 0.3}), "mfm", "geomed"]


def _assert_like_jax(t_outs, j_outs, atol=1e-5):
    assert len(t_outs) == len(j_outs)
    for c, ((tp, tl), (jp, jl)) in enumerate(zip(t_outs, j_outs)):
        assert logs_of(tl) == logs_of(jl), c
        want = to_numpy(jp)
        for k in want:
            np.testing.assert_allclose(tp[k].numpy(), want[k], rtol=0,
                                       atol=atol, err_msg=f"lane {c} {k}")


def test_sweep_equals_jax_sweep_mixed_rules_attacks_deltas():
    tt, jt = torch_softmax(), jax_softmax()
    tcfg, jcfg = _cfgs()
    sws = _switchers(len(JAX_AGGS))
    t_outs = t_rt.run_dynabro_scan_sweep(
        tt.grad_fn, tt.params0, t_optim.sgd(0.1), tcfg,
        [t_switching.get_switcher(nm, M, **kw) for nm, kw in sws],
        tt.make_sampler(M), T, seed=SEED, attacks=JAX_ATTACKS,
        aggregators=JAX_AGGS)
    j_outs = j_rt.run_dynabro_scan_sweep(
        jt.grad_fn, jt.params0, j_optim.sgd(0.1), jcfg,
        [j_switching.get_switcher(nm, M, **kw) for nm, kw in sws],
        jt.make_sampler(M), T, seed=SEED, attacks=JAX_ATTACKS,
        aggregators=JAX_AGGS, vectorize_batches=False)
    _assert_like_jax(t_outs, j_outs)


def test_replicate_seeds_equal_jax():
    """Replicate lanes: masks, batches and the generator from each
    replicate seed, the level plan from the session's; adagrad_norm, whose
    state is per lane."""
    ts, js = _sessions(t_optim.adagrad_norm(0.5), j_optim.adagrad_norm(0.5))
    kw = dict(switchers=tuple(_switchers(2)), aggregators=("cwtm", "krum"),
              attacks=("ipm", "sign_flip"), seeds=(0, 3, 11))
    t_outs = ts.sweep(t_specs.SweepSpec(**kw), T)
    j_outs = js.sweep(j_specs.SweepSpec(**kw), T)
    assert len(t_outs) == 2 and all(len(cell) == 3 for cell in t_outs)
    for tc, jc in zip(t_outs, j_outs):
        _assert_like_jax(tc, jc)
    lanes = [p["w"] for cell in t_outs for p, _ in cell]
    assert not torch.equal(lanes[0], lanes[1])  # the replicates differ


