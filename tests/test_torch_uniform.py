"""The port's theta forms against the JAX package's: each rule's uniform
form (``agg_engine.uniform_aggregator``, ``nnm+`` composites and MFM's NaN
tau included) on the same stacks at 1e-6, the lane forms (``agg_switch``,
``attack_switch``) against one lane at a time, the theta rows,
``traced_trim_count`` against ``trim_count`` where δ·m is an exact integer,
and ``mlmc_combine(threshold=)``. The JAX forms run on the plain backend,
as the JAX package's own tests run them on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agg_engine as j_engine
from repro.core import attacks as j_attacks
from repro.core import mlmc as j_mlmc
from repro_torch.core import agg_engine as t_engine
from repro_torch.core import attacks as t_attacks
from repro_torch.core import mlmc as t_mlmc

MLMC = dict(T=64, m=9, V=2.0)
RULES = [("mean", {}), ("cwmed", {}), ("cwtm", {}), ("cwtm", {"delta": 0.4}),
         ("cwtm", {"delta": 1 / 3}), ("krum", {}),
         ("krum", {"delta": 0.2, "multi": 3}), ("geomed", {}),
         ("geomed", {"iters": 3, "eps": 1e-6}), ("mfm", {}),
         ("mfm", {"tau": 4.0}), ("nnm+mean", {}), ("nnm+cwmed", {}),
         ("nnm+cwtm", {}), ("nnm+cwtm", {"delta": 0.3}),
         ("nnm+krum", {"multi": 2}), ("nnm+geomed", {"iters": 5}),
         ("nnm+mfm", {"tau": 3.0})]


def _stack(m, seed):
    rng = np.random.default_rng(seed)
    out = {"a": rng.normal(size=(m, 7)), "b": rng.normal(size=(m, 2, 3))}
    out["a"][0] += 5.0  # an outlier row
    return {k: v.astype(np.float32) for k, v in out.items()}


def _close(got, want, atol=1e-6):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("m", [5, 9])
@pytest.mark.parametrize("name,kw", RULES,
                         ids=[f"{n}{kw}" for n, kw in RULES])
def test_uniform_form_equals_jax(name, kw, m):
    stack = _stack(m, m)
    for n in (1, 4):
        jfn = j_engine.uniform_aggregator(name, backend="ref",
                                          mlmc=j_mlmc.MLMCConfig(**MLMC))
        tfn = t_engine.uniform_aggregator(name, backend="ref",
                                          mlmc=t_mlmc.MLMCConfig(**MLMC))
        want = jfn({k: jnp.asarray(v) for k, v in stack.items()}, n,
                   jnp.asarray(j_engine.agg_theta(name, kw)))
        got = tfn({k: torch.from_numpy(v) for k, v in stack.items()}, n,
                  torch.from_numpy(t_engine.agg_theta(name, kw)))
        _close(got, want)


@pytest.mark.parametrize("name,kw", RULES, ids=[f"{n}{kw}" for n, kw in RULES])
def test_uniform_form_equals_class_rule(name, kw):
    """On the plain backend the uniform form computes the class rule at the
    same hyperparameters: bitwise, but for NNM's 1/k (a float32 division of
    a count held in a tensor, where the class rule's is a Python float)."""
    m, n = 9, 4
    cfg = t_mlmc.MLMCConfig(**MLMC)
    stack = {k: torch.from_numpy(v) for k, v in _stack(m, 3).items()}
    got = t_engine.uniform_aggregator(name, backend="ref", mlmc=cfg)(
        stack, n, torch.from_numpy(t_engine.agg_theta(name, kw)))
    kw2 = dict(kw)
    if name == "mfm":
        rule = t_engine.get_aggregator("mfm", backend="ref")
        want = rule.tree(stack, tau=kw2.get("tau", cfg.mfm_tau(n)))
    else:
        delta = kw2.pop("delta", 0.25)
        want = t_engine.get_aggregator(name, delta=delta, backend="ref",
                                       **kw2).tree(stack)
    if name.startswith("nnm+"):
        _close(got, want)
    else:
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_agg_switch_runs_each_rule_on_its_lanes():
    """``agg_switch`` over mixed lanes equals each lane's uniform form bit
    for bit, with one level or three (a leading level axis)."""
    names = ("cwtm", "krum", "nnm+cwtm", "mean", "mfm")
    ids = [0, 1, 2, 0, 3, 4, 2, 0]
    m = 9
    cfg = t_mlmc.MLMCConfig(**MLMC)
    rng = np.random.default_rng(4)
    lanes = {"a": torch.from_numpy(rng.normal(size=(3, len(ids), m, 5)).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(3, len(ids), m, 2)).astype(np.float32))}
    deltas = [0.1, 0.2, 0.3, 0.4, 0.45, 0.15, 0.25, 1 / 3]
    theta = torch.from_numpy(np.stack([
        t_engine.agg_theta(names[i], {"delta": d}) for i, d in zip(ids, deltas)]))
    apply = t_engine.agg_switch(names, backend="ref", mlmc=cfg)
    three = apply(ids, lanes, (1, 2, 4), theta)
    for lvl, n in enumerate((1, 2, 4)):
        one = apply(ids, {k: v[lvl] for k, v in lanes.items()}, n, theta)
        for c, i in enumerate(ids):
            fn = t_engine.uniform_aggregator(names[i], backend="ref", mlmc=cfg)
            want = fn({k: v[lvl, c] for k, v in lanes.items()}, n, theta[c])
            for k in want:
                assert torch.equal(one[k][c], want[k]), (c, k)
                assert torch.equal(three[k][lvl, c], want[k]), (c, k)


@pytest.mark.parametrize("name", sorted(t_engine.AGG_PARAMS))
def test_agg_theta_and_spec_equal_jax(name):
    for nm in (name, "nnm+" + name):
        assert t_engine.agg_param_spec(nm) == j_engine.agg_param_spec(nm)
        assert t_engine.agg_param_names(nm) == j_engine.agg_param_names(nm)
        if nm == "nnm+mfm":  # no auto tau behind NNM: None raises in both
            for engine in (t_engine, j_engine):
                with pytest.raises(TypeError, match="does not accept None"):
                    engine.agg_theta(nm)
            continue
        np.testing.assert_array_equal(t_engine.agg_theta(nm),
                                      np.asarray(j_engine.agg_theta(nm)))
    assert t_engine.N_AGG_PARAMS == j_engine.N_AGG_PARAMS
    assert t_engine.AGG_NAN_SENTINELS == j_engine.AGG_NAN_SENTINELS
    assert t_engine.GEOMED_MAX_ITERS == j_engine.GEOMED_MAX_ITERS


def test_attack_theta_equals_jax():
    assert t_attacks.ATTACK_PARAMS == j_attacks.ATTACK_PARAMS
    assert t_attacks.N_PARAMS == j_attacks.N_PARAMS
    assert t_attacks.NAN_SENTINEL_PARAMS == j_attacks.NAN_SENTINEL_PARAMS
    for name, kw in [("none", {}), ("sign_flip", {"scale": 3.0}), ("ipm", {}),
                     ("alie", {"z": None}), ("random", {"scale": 2.0}),
                     ("shift", {"v": -0.5})]:
        np.testing.assert_array_equal(t_attacks.attack_theta(name, kw),
                                      np.asarray(j_attacks.attack_theta(name, kw)))
    for kw, err in [({"eps": None}, TypeError), ({"nope": 1}, TypeError)]:
        with pytest.raises(err):
            t_attacks.attack_theta("ipm", kw)


DETERMINISTIC = [("none", {}), ("sign_flip", {"scale": 2.0}), ("ipm", {"eps": 0.3}),
                 ("alie", {"z": 1.5}), ("alie", {"z": None}), ("shift", {"v": -0.5})]


@pytest.mark.parametrize("name,kw", DETERMINISTIC,
                         ids=[f"{n}{kw}" for n, kw in DETERMINISTIC])
def test_uniform_attack_equals_jax(name, kw):
    rng = np.random.default_rng(5)
    m = 9
    stack = {"a": rng.normal(size=(m, 6)).astype(np.float32),
             "b": rng.normal(size=(m, 2, 2)).astype(np.float32)}
    mask = rng.random(m) < 0.4
    mask[0] = True
    theta = t_attacks.attack_theta(name, kw)
    want = j_attacks.uniform_attack(name)(
        {k: jnp.asarray(v) for k, v in stack.items()}, jnp.asarray(mask),
        jax.random.PRNGKey(0), jnp.asarray(theta))
    got = t_attacks.uniform_attack(name)(
        {k: torch.from_numpy(v) for k, v in stack.items()},
        torch.from_numpy(mask), None, torch.from_numpy(theta))
    _close(got, want)


def test_attack_switch_per_lane_and_one_random_draw():
    """``attack_switch`` over mixed lanes: each deterministic lane equals
    its uniform attack mapped over the n computations, bitwise; every
    ``random`` lane scales the one draw a lone run makes from the same
    generator state by its own scale."""
    names = ("sign_flip", "random", "ipm", "alie")
    ids = [0, 1, 2, 1, 3, 0]
    C, n, m = len(ids), 4, 7
    rng = np.random.default_rng(6)
    stacked = {"a": torch.from_numpy(rng.normal(size=(C, n, m, 5)).astype(np.float32)),
               "b": torch.from_numpy(rng.normal(size=(C, n, m)).astype(np.float32))}
    masks = torch.from_numpy(rng.random((C, n, m)) < 0.4)
    kws = [{"scale": 2.0}, {"scale": 3.0}, {"eps": 0.2}, {"scale": 0.5},
           {"z": None}, {}]
    theta = torch.from_numpy(np.stack(
        [t_attacks.attack_theta(names[i], kw) for i, kw in zip(ids, kws)]))
    got = t_attacks.attack_switch(names)(ids, stacked, masks,
                                         torch.Generator().manual_seed(9), theta)
    noise = t_attacks.draw_noise({k: v[0] for k, v in stacked.items()},
                                 torch.Generator().manual_seed(9))
    for c, i in enumerate(ids):
        one = {k: v[c] for k, v in stacked.items()}
        if names[i] == "random":
            want = t_attacks.random_noise(one, masks[c],
                                          torch.Generator().manual_seed(9),
                                          scale=kws[c]["scale"])
            assert all(torch.equal(want[k], t_attacks.apply_noise(
                one, masks[c], noise, kws[c]["scale"])[k]) for k in want)
        else:
            atk = t_attacks.get_attack(names[i], **kws[c])
            want = {k: torch.stack([atk({q: v[u] for q, v in one.items()},
                                        masks[c, u])[k] for u in range(n)])
                    for k in one}
        for k in want:
            assert torch.equal(got[k][c], want[k]), (c, names[i], k)


def _exact_products():
    """(δ, m) pairs whose δ·m is an integer in exact arithmetic: k/m for
    every k, and decimal δ such as 0.28·25 = 7 or 0.3·10 = 3."""
    pairs = [(k / m, m) for m in range(2, 33) for k in range(m + 1)]
    pairs += [(d / 100, m) for m in (4, 5, 10, 20, 25, 50)
              for d in range(0, 101) if (d * m) % 100 == 0]
    return pairs


def test_traced_trim_count_equals_trim_count():
    pairs = _exact_products()
    deltas = torch.tensor([d for d, _ in pairs], dtype=torch.float32)
    for m in sorted({m for _, m in pairs}):
        sel = [i for i, (_, mm) in enumerate(pairs) if mm == m]
        got = t_engine.traced_trim_count(deltas[sel], m)
        want = [t_engine.trim_count(pairs[i][0], m) for i in sel]
        jax_got = j_engine.traced_trim_count(jnp.asarray(deltas[sel].numpy()), m)
        assert got.dtype == torch.int32
        assert got.tolist() == want == np.asarray(jax_got).tolist(), m
    counts = t_engine.traced_count(torch.tensor([7.0, 7.001, 6.99999, 0.0]))
    assert counts.tolist() == [7, 8, 7, 0]


def test_mlmc_combine_threshold_and_norm_fn():
    rng = np.random.default_rng(7)
    trees = [{"a": rng.normal(size=(4,)).astype(np.float32),
              "b": rng.normal(size=(2, 3)).astype(np.float32)} for _ in range(3)]
    tt = [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees]
    jt = [{k: jnp.asarray(v) for k, v in t.items()} for t in trees]
    cfg_t, cfg_j = t_mlmc.MLMCConfig(**MLMC), j_mlmc.MLMCConfig(**MLMC)
    j = 2
    dn = float(t_mlmc.tree_norm({k: tt[2][k] - tt[1][k] for k in tt[0]}))
    for thr in (None, dn * 0.999, dn * 1.001, dn):
        t_thr = None if thr is None else torch.tensor(thr, dtype=torch.float32)
        g, info = t_mlmc.mlmc_combine(*tt, j, cfg_t, threshold=t_thr)
        gj, infoj = j_mlmc.mlmc_combine(*jt, j, cfg_j, threshold=None if thr is None
                                        else jnp.float32(thr))
        assert bool(info["failsafe_ok"]) == bool(infoj["failsafe_ok"])
        _close(g, gj)
    g0, _ = t_mlmc.mlmc_combine(*tt, j, cfg_t)
    g1, _ = t_mlmc.mlmc_combine(*tt, j, cfg_t,
                                threshold=torch.tensor(cfg_t.threshold(j)))
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    _, info = t_mlmc.mlmc_combine(*tt, j, cfg_t,
                                  norm_fn=lambda d: torch.tensor(1e9))
    assert not bool(info["failsafe_ok"]) and float(info["corr_norm"]) == 1e9
