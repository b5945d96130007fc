"""``repro_torch.api.specs`` against the JAX package's ``repro.api.specs``:
the same specs give the same labels, theta rows, legacy forms, per-cell
configs and lane subsets, and the same invalid specs raise the same errors
with the same messages."""
import dataclasses

import numpy as np
import pytest

from repro.api import specs as j_specs
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro_torch.api import specs as t_specs
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching

ATTACKS = ["none", "sign_flip", ("sign_flip", {"scale": 2.0}), "ipm",
           ("ipm", {"eps": 0.3}), ("alie", {"z": None}), ("alie", {"z": 1.5}),
           "random", ("random", {"scale": 3.0}), ("shift", {"v": -1.0})]
AGGS = ["mean", "cwmed", "cwtm", ("cwtm", {"delta": 0.3}), "krum",
        ("krum", {"delta": 0.2, "multi": 2}), "geomed",
        ("geomed", {"iters": 4, "eps": 1e-6}), "mfm", ("mfm", {"tau": 2.5}),
        "nnm+cwtm", ("nnm+cwtm", {"delta": 0.4}), ("nnm+krum", {"multi": 3}),
        ("nnm+geomed", {"iters": 3}), ("nnm+mfm", {"tau": 1.0}),
        ("mean", {"delta": 0.1})]
BAD_ATTACKS = ["nosuch", ("sign_flip", {"eps": 1.0}), ("ipm", {"eps": None}),
               ("random", {"scale": None}), 3, ("alie",)]
BAD_AGGS = ["nosuch", "nnm+nosuch", ("cwtm", {"tau": 1.0}),
            ("krum", {"delta": None}), ("geomed", {"iters": 9}),
            ("nnm+mfm", {"tau": None}), 7, ("krum",)]


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the error itself is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("spec", ATTACKS, ids=str)
def test_attack_spec_equals_jax(spec):
    j, t = j_specs.AttackSpec.coerce(spec), t_specs.AttackSpec.coerce(spec)
    assert (t.name, t.params, t.label, t.legacy) == (j.name, j.params, j.label,
                                                     j.legacy)
    np.testing.assert_array_equal(t.theta(), np.asarray(j.theta()))
    assert t == t_specs.AttackSpec.make(t.name, **t.kwargs)


@pytest.mark.parametrize("spec", AGGS, ids=str)
def test_agg_spec_equals_jax(spec):
    j, t = j_specs.AggSpec.coerce(spec), t_specs.AggSpec.coerce(spec)
    assert (t.rule, t.params, t.label, t.legacy) == (j.rule, j.params, j.label,
                                                     j.legacy)
    np.testing.assert_array_equal(t.theta(), np.asarray(j.theta()))
    kw = dict(T=64, m=9, V=2.0, kappa=1.5)
    assert t.thr_coeff(t_mlmc.MLMCConfig(**kw)) == j.thr_coeff(
        j_mlmc.MLMCConfig(**kw))
    jc = j.apply_to(j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**kw), delta=0.2))
    tc = t.apply_to(t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**kw), delta=0.2))
    assert dataclasses.asdict(tc.mlmc) == dataclasses.asdict(jc.mlmc)
    assert (tc.aggregator, tc.delta, tc.aggregator_kwargs) == (
        jc.aggregator, jc.delta, jc.aggregator_kwargs)


@pytest.mark.parametrize("spec", BAD_ATTACKS, ids=str)
def test_bad_attack_spec_raises_as_jax(spec):
    want = _error(lambda: j_specs.AttackSpec.coerce(spec))
    assert want is not None
    assert _error(lambda: t_specs.AttackSpec.coerce(spec)) == want


@pytest.mark.parametrize("spec", BAD_AGGS, ids=str)
def test_bad_agg_spec_raises_as_jax(spec):
    want = _error(lambda: j_specs.AggSpec.coerce(spec))
    assert want is not None
    assert _error(lambda: t_specs.AggSpec.coerce(spec)) == want


SWEEP_CASES = [
    dict(switchers=("static", ("periodic", {"n_byz": 2, "K": 3})),
         attacks=("ipm", "sign_flip")),
    dict(switchers=("static",) * 3, aggregators=("cwtm", "krum", "mfm"),
         seeds=(3, 1, 2)),
    dict(switchers=("static",), replicates=2),
    dict(switchers=("static", "static"), attacks=("ipm",)),
    dict(switchers=("static",), aggregators=("cwtm", "krum")),
    dict(switchers=("static",), seeds=()),
    dict(switchers=("static",), seeds=(1, 1)),
    dict(switchers=("static",), seeds=(1, 2), replicates=3),
    dict(switchers=("static",), replicates=0),
    dict(switchers=("static",), attacks=("nosuch",)),
]


@pytest.mark.parametrize("kw", SWEEP_CASES, ids=range(len(SWEEP_CASES)))
def test_sweep_spec_equals_jax(kw):
    want = _error(lambda: j_specs.SweepSpec(**kw))
    got = _error(lambda: t_specs.SweepSpec(**kw))
    assert got == want
    if want is not None:
        return
    j, t = j_specs.SweepSpec(**kw), t_specs.SweepSpec(**kw)
    assert (t.lanes, t.n_replicates, t.replicate_seeds(5), t.attack_lanes(),
            t.agg_lanes()) == (j.lanes, j.n_replicates, j.replicate_seeds(5),
                               j.attack_lanes(), j.agg_lanes())
    for idx in ([0], list(range(t.lanes))[::-1]):
        js, ts = j.lane_subset(idx), t.lane_subset(idx)
        assert (ts.switchers, ts.seeds, ts.replicates) == (
            js.switchers, js.seeds, js.replicates)
        assert [a.label for a in ts.attacks or []] == [
            a.label for a in js.attacks or []]
        assert [g.label for g in ts.aggregators or []] == [
            g.label for g in js.aggregators or []]


def test_resolve_switchers():
    spec = t_specs.SweepSpec(switchers=(
        ("periodic", {"n_byz": 2, "K": 3}),
        t_switching.get_switcher("static", 6, n_byz=1)))
    sws = spec.resolve_switchers(6, 0)
    assert [type(s).__name__ for s in sws] == ["Periodic", "Static"]
    np.testing.assert_array_equal(sws[0].mask(4), t_switching.get_switcher(
        "periodic", 6, n_byz=2, K=3).mask(4))
    with pytest.raises(ValueError, match="worker count"):
        t_specs.SweepSpec(switchers=("static",)).resolve_switchers(None, 0)
    with pytest.raises(ValueError, match="re-seeded"):
        t_specs.SweepSpec(switchers=(sws[1],), replicates=2).resolve_switchers(6, 0)
