"""The port's lane-batched sweep (``run_dynabro_scan_sweep``,
``Session.sweep``) on the CPU: each lane against a lone
``run_dynabro_scan`` of that lane (round logs equal, params within 1e-6 for
CWTM and 1e-5 for the geometry rules: the lanes' attacks and optimizer run
batched), for mixed rules, per-lane attacks (``random`` included) and
per-lane δ; ``lane_chunk``, segment chunks and the replicate axis change no
lane's bits; prebuilt scan_fns and the refused options.
``test_torch_sweep_jax.py`` holds the sweep against the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_tasks import jax_softmax, logs_of, torch_softmax
from repro.api import session as j_session
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.optim import optimizers as j_optim
from repro_torch.api import session as t_session
from repro_torch.api import specs as t_specs
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import optimizers as t_optim

M, T, SEED = 7, 12, 2
MLMC = dict(T=T, m=M, V=2.0, j_cap=3)
KS = (2, 3, 5, 4, 6, 3, 2, 5)


def _switchers(n):
    return [("periodic", {"n_byz": 3, "K": KS[c % len(KS)]}) for c in range(n)]


def _cfgs(**kw):
    base = dict(aggregator="cwtm", delta=3 / M + 1e-3, attack="sign_flip", **kw)
    return (t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**MLMC), **base),
            j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**MLMC), **base))


def _lone(task, cfg, sw, attack, agg, opt):
    a = t_specs.AttackSpec.coerce(attack or cfg.attack)
    cfg = dataclasses.replace(cfg, attack=a.name, attack_kwargs=a.kwargs or None)
    if agg is not None:
        cfg = t_specs.AggSpec.coerce(agg).apply_to(cfg)
    name, kw = sw
    return t_rt.run_dynabro_scan(task.grad_fn, task.params0, opt, cfg,
                                 t_switching.get_switcher(name, M, **kw),
                                 task.make_sampler(M), T, seed=SEED)


def _limit(agg):
    rule = "cwtm" if agg is None else t_specs.AggSpec.coerce(agg).rule
    return 1e-6 if rule in ("cwtm", "cwmed", "mean") else 1e-5


CASES = {
    "switchers": (None, None),
    "attacks": (["sign_flip", ("ipm", {"eps": 0.4}), ("alie", {"z": None}),
                 ("random", {"scale": 2.0}), ("shift", {"v": 0.5}),
                 ("random", {"scale": 5.0})], None),
    "deltas": (None, [("cwtm", {"delta": d}) for d in (0.1, 0.2, 0.3, 0.45)]),
    "rules": (["sign_flip", "ipm", "random", "sign_flip", "alie", "sign_flip",
               "ipm"],
              [("cwtm", {"delta": 0.3}), "krum", ("nnm+cwtm", {"delta": 0.3}),
               "geomed", "mfm", "cwmed", ("nnm+krum", {"delta": 0.3})]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_lane_equals_its_lone_run(case):
    attacks, aggs = CASES[case]
    n = len(attacks or aggs or [0] * 3)
    task = torch_softmax()
    cfg, _ = _cfgs()
    sws = _switchers(n)
    outs = t_rt.run_dynabro_scan_sweep(
        task.grad_fn, task.params0, t_optim.sgd(0.1), cfg,
        [t_switching.get_switcher(nm, M, **kw) for nm, kw in sws],
        task.make_sampler(M), T, seed=SEED, attacks=attacks, aggregators=aggs)
    assert len(outs) == n
    for c, (p, logs) in enumerate(outs):
        agg = None if aggs is None else aggs[c]
        p1, l1, _ = _lone(task, cfg, sws[c], None if attacks is None
                          else attacks[c], agg, t_optim.sgd(0.1))
        assert logs_of(logs) == logs_of(l1), c
        for k in p1:
            np.testing.assert_allclose(p[k].numpy(), p1[k].numpy(), rtol=0,
                                       atol=_limit(agg), err_msg=f"lane {c} {k}")


def _sessions(opt_t=None, opt_j=None, **kw):
    tt, jt = torch_softmax(), jax_softmax()
    tcfg, jcfg = _cfgs(**kw)
    ts = t_session.Session(tcfg, grad_fn=tt.grad_fn, params0=tt.params0,
                           opt=opt_t or t_optim.sgd(0.1), m=M,
                           sample_batches=tt.make_sampler(M), seed=SEED,
                           sampler_factory=t_session._task_sampler_factory(tt, M))
    js = j_session.Session(jcfg, grad_fn=jt.grad_fn, params0=jt.params0,
                           opt=opt_j or j_optim.sgd(0.1), m=M,
                           sample_batches=jt.make_sampler(M), seed=SEED,
                           vectorize_batches=False,
                           sampler_factory=j_session._task_sampler_factory(jt, M))
    return ts, js


def test_replicate_lane_is_its_single_seed_sweep_bitwise():
    ts, _ = _sessions()
    kw = dict(switchers=tuple(_switchers(3)),
              attacks=("random", "ipm", ("random", {"scale": 3.0})))
    rep = ts.sweep(t_specs.SweepSpec(seeds=(SEED, 5, 9), **kw), T)
    for r, s in enumerate((SEED, 5, 9)):
        solo = ts.sweep(t_specs.SweepSpec(seeds=(s,), **kw), T)
        for cell, one in zip(rep, solo):
            assert logs_of(cell[r][1]) == logs_of(one[1])
            assert all(torch.equal(cell[r][0][k], one[0][k]) for k in one[0])
    plain = ts.sweep(t_specs.SweepSpec(**kw), T)
    for cell, one in zip(rep, plain):  # the session seed's replicate
        assert all(torch.equal(cell[0][0][k], one[0][k]) for k in one[0])


def test_lane_chunk_and_segment_chunk_change_no_bits():
    ts, _ = _sessions()
    spec = t_specs.SweepSpec(
        switchers=tuple(_switchers(5)),
        aggregators=("cwtm", "krum", "cwtm", ("nnm+cwtm", {"delta": 0.3}),
                     "krum"),
        attacks=("sign_flip", "random", "ipm", "random", "alie"))
    whole = ts.sweep(spec, T)
    for kw in ({"lane_chunk": 2}, {"lane_chunk": 1, "chunk": 5},
               {"chunk": 4}):
        got = ts.sweep(spec, T, **kw)
        for (p, logs), (p1, l1) in zip(got, whole):
            assert logs_of(logs) == logs_of(l1)
            assert all(torch.equal(p[k], p1[k]) for k in p)


def test_prebuilt_scan_fns_and_their_checks():
    ts, _ = _sessions()
    tt = torch_softmax()
    cfg, _ = _cfgs()
    aggs = ("cwtm", "krum", "cwtm")
    spec = t_specs.SweepSpec(switchers=tuple(_switchers(3)), aggregators=aggs)
    plain = ts.sweep(spec, T)
    fns = {r: t_rt.make_dynabro_scan_fn(tt.grad_fn, cfg, t_optim.sgd(0.1),
                                        lane_aggregators=(r,))
           for r in ("cwtm", "krum", "mfm")}
    mapped = ts.sweep(dataclasses.replace(spec, scan_fn=fns), T)
    for (p, _), (p1, _) in zip(mapped, plain):
        assert all(torch.equal(p[k], p1[k]) for k in p)
    assert ts._lane_fns  # the session keeps the scan_fns it builds
    kept = dict(ts._lane_fns)
    ts.sweep(spec, T)
    assert ts._lane_fns == kept
    with pytest.raises(ValueError, match="do not cover"):
        ts.sweep(dataclasses.replace(spec, scan_fn={"cwtm": fns["cwtm"]}), T)
    one = t_specs.SweepSpec(switchers=tuple(_switchers(2)),
                            aggregators=("cwtm", "cwtm"))
    with pytest.raises(ValueError, match="derive"):
        ts.sweep(dataclasses.replace(one, scan_fn=fns["krum"]), T)
    with pytest.raises(ValueError, match="passes no aggregators"):
        ts.sweep(t_specs.SweepSpec(switchers=one.switchers,
                                   scan_fn=fns["cwtm"]), T)
    # a plain scan_fn of the session's cfg runs its lane form
    plain_fn = t_rt.make_dynabro_scan_fn(tt.grad_fn, cfg, t_optim.sgd(0.1))
    a = ts.sweep(t_specs.SweepSpec(switchers=one.switchers, scan_fn=plain_fn), T)
    b = ts.sweep(t_specs.SweepSpec(switchers=one.switchers), T)
    for (p, _), (p1, _) in zip(a, b):
        assert all(torch.equal(p[k], p1[k]) for k in p)


def test_empty_sweeps_and_unported_options():
    ts, _ = _sessions()
    assert ts.sweep(t_specs.SweepSpec(switchers=()), T) == []
    out = ts.sweep(t_specs.SweepSpec(switchers=tuple(_switchers(2))), 0)
    assert [logs for _, logs in out] == [[], []]
    rep = ts.sweep(t_specs.SweepSpec(switchers=tuple(_switchers(1)),
                                     replicates=2), 0)
    assert len(rep) == 1 and len(rep[0]) == 2
    spec = t_specs.SweepSpec(switchers=tuple(_switchers(1)))
    # lane_mesh= is ported (tests/test_torch_mesh.py): a mesh of other axes
    # is refused as the JAX package refuses it
    with pytest.raises(ValueError, match="lanes"):
        ts.sweep(spec, T, lane_mesh=Mesh(("workers",), (1,)))
    mom = t_session.Session(_cfgs()[0], grad_fn=None, params0=None,
                            mode="momentum", lr=0.1, beta=0.9, m=M)
    with pytest.raises(ValueError, match="dynabro-mode"):
        mom.sweep(spec, T)
