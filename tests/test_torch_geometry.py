"""The port's geometry primitives and rules (repro_torch.kernels /
core.agg_engine / core.aggregators) against the JAX package's: its Pallas
kernels run in interpret mode as tests/test_agg_engine.py runs them, its
plain references (repro/kernels/ref.py), and its rules on the ``ref`` and
``pallas`` backends. Inputs are numpy draws from a seed, handed to both.

Tolerances: rtol = atol = 1e-5 for combines, reduces and rules (those of
tests/test_agg_engine.py). Squared distances are held to atol 2e-6 after
dividing both sides by the larger of the largest distance and the largest
squared row norm: the Gram expansion cancels relative to the row norms, so
at m = 1 the only distance is that cancellation residue. The weight cores
(Krum's pick, NNM's neighbours, MFM's filter) must be equal, ties included.

On the CPU every wrapper computes its plain version; the CUDA kernels are
held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agg_engine as j_engine
from repro.core import aggregators as j_rules
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import agg_engine as t_engine
from repro_torch.core import aggregators as t_rules
from repro_torch.kernels import fused
from repro_torch.kernels import ref as kref

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = {"b1": (7,), "b2": (3,), "w1": (5, 7), "w2": (7, 3)}


@functools.cache
def _stack(m, d, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(m, d)) * scale
            ).astype(np.float32)


@functools.cache
def _weights(k, m, seed):
    w = np.random.default_rng(seed).random((k, m)).astype(np.float32)
    return w / w.sum(1, keepdims=True)


def _t(x, bf16=False):
    xt = torch.from_numpy(np.ascontiguousarray(x))
    return xt.to(torch.bfloat16) if bf16 else xt


def _j(x, bf16=False):
    xj = jnp.asarray(x)
    return xj.astype(jnp.bfloat16) if bf16 else xj


def _dist_close(got, want, *rows, off_diagonal=False):
    """Within atol 2e-6 after scaling; ``off_diagonal`` leaves out the
    diagonal of a pairwise matrix, where each implementation holds only its
    own cancellation residue (the exact value, 0, is checked instead)."""
    got, want = np.asarray(got), np.asarray(want)
    norms = max(float((np.asarray(r, np.float32) ** 2).sum(1).max()) for r in rows)
    scale = max(float(want.max()), norms, 1e-30)
    keep = ~np.eye(*got.shape, dtype=bool) if off_diagonal else np.ones(
        got.shape, bool)
    np.testing.assert_allclose(got[keep] / scale, want[keep] / scale, rtol=0,
                               atol=2e-6)


def _tree(m, seed, far=()):
    """A worker-stacked dict of SHAPES: workers near one point, those in
    ``far`` 5 away, so that every rule's choices are clear-cut."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in SHAPES.items():
        v = rng.normal(size=s) + 0.1 * rng.normal(size=(m,) + s)
        v[list(far)] += 5.0
        out[k] = v.astype(np.float32)
    return out


def _close_tree(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **(tol or TOL))


# ------------------------------------------------- kernel wrappers (CPU)


@functools.cache
def _jax_pairwise(m, d, bf16):
    return np.asarray(jops.pairwise_sqdist_op(_j(_stack(m, d, m + d), bf16)))


@pytest.mark.parametrize("m", [1, 3, 17, 32])
@pytest.mark.parametrize("d", [50, 4096])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pairwise_sqdist_matches_jax(m, d, bf16):
    x = _stack(m, d, m + d)
    got = fused.pairwise_sqdist(_t(x, bf16)).numpy()
    assert got.shape == (m, m)
    np.testing.assert_array_equal(got, got.T)
    rows = np.asarray(_j(x, bf16).astype(jnp.float32))
    exact = ((rows[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1)
    _dist_close(got, exact, rows)
    # off the diagonal only: on bf16 rows at d = 4096 the JAX versions'
    # diagonal residues (their own cancellation) exceed the tolerance
    _dist_close(got, jref.pairwise_sqdist_ref(_j(x, bf16)), rows,
                off_diagonal=True)
    if not bf16:  # on bf16 rows at d = 4096 the interpreted Pallas kernel
        # itself is further than the tolerance from the exact distances
        _dist_close(got, _jax_pairwise(m, d, bf16), rows, off_diagonal=True)
    _dist_close(t_engine.pairwise_sqdist(_t(x, bf16)).numpy(), got, rows)


@pytest.mark.parametrize("m,k", [(1, 1), (17, 1), (17, 3), (5, 8)])
@pytest.mark.parametrize("d", [50, 4096])
def test_cross_sqdist_matches_jax(m, k, d):
    x, y = _stack(m, d, m), _stack(k, d, 100 + k)
    got = fused.cross_sqdist(_t(x), _t(y)).numpy()
    assert got.shape == (m, k)
    want = np.asarray(jops.cross_sqdist_op(_j(x), _j(y)))
    _dist_close(got, want, x, y)
    _dist_close(got, jref.cross_sqdist_ref(_j(x), _j(y)), x, y)


def test_cross_sqdist_is_direct_subtraction():
    """Offsets of ~1e-3 a coordinate from a point of norm ~1e3: the Gram
    expansion rounds such distances to noise in float32, direct subtraction
    keeps them."""
    base = _stack(1, 4096, 5, 20.0)
    x = base + _stack(6, 4096, 6, 1e-3)
    got = fused.cross_sqdist(_t(x), _t(base)).numpy()[:, 0]
    exact = ((x.astype(np.float64) - base) ** 2).sum(1)
    np.testing.assert_allclose(got, exact, rtol=1e-4)


@pytest.mark.parametrize("m", [3, 17])
@pytest.mark.parametrize("k", ["1", "m"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_weighted_combine_matches_jax(m, k, bf16):
    k = 1 if k == "1" else m
    x, w = _stack(m, 777, m), _weights(k, m, k)
    got = fused.weighted_combine(_t(x, bf16), _t(w)).numpy()
    assert got.shape == (k, 777)
    want = np.asarray(jops.weighted_combine_op(_j(x, bf16), _j(w)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.weighted_combine_ref(_j(x, bf16), _j(w))), **TOL)


@functools.cache
def _jax_fused(m, k, d, mode, trim, pairwise, combine, has_w):
    x = _j(_stack(m, d, 7 * m + k))
    w = _j(_weights(k, m, 3)) if has_w else None
    out = jops.fused_op(x, w, reduce=mode, trim=trim, pairwise=pairwise,
                        combine=combine)
    return {key: np.asarray(v) for key, v in out.items()}


@pytest.mark.parametrize("mode", fused.REDUCE_MODES)
@pytest.mark.parametrize("k,trim", [(5, 1), (16, 4), (16, 100), (17, 8)])
def test_combine_reduce_matches_jax(mode, k, trim):
    """The reduce runs over the k mixed rows, the trim clipped to (k-1)//2."""
    m, d = 17, 300
    x, w = _stack(m, d, 7 * m + k), _weights(k, m, 3)
    got = fused.combine_reduce(_t(x), _t(w), mode, trim).numpy()
    want = _jax_fused(m, k, d, mode, trim if mode == "tm" else 0, False, False,
                      True)["reduce"]
    np.testing.assert_allclose(got, want, **TOL)
    clipped = min(trim, (k - 1) // 2)
    np.testing.assert_allclose(
        t_engine.combine_reduce(_t(x), _t(w), mode, clipped).numpy(), got,
        **TOL)


STAGES = [dict(reduce="tm"), dict(pairwise=True), dict(combine=True),
          dict(reduce="med", pairwise=True), dict(reduce="tm", combine=True),
          dict(pairwise=True, combine=True),
          dict(reduce="mean", pairwise=True, combine=True)]


@pytest.mark.parametrize("stages,has_w",
                         [(s, w) for s in STAGES for w in (False, True)
                          if w or not s.get("combine")],
                         ids=lambda v: "+".join(sorted(v)) if isinstance(v, dict)
                         else ("w@x" if v else "x"))
def test_fused_pass_matches_jax(stages, has_w):
    m, k, d = 9, 9, 333
    mode = stages.get("reduce")
    trim = 3 if mode == "tm" else 0
    x = _stack(m, d, 7 * m + k)
    w = _t(_weights(k, m, 3)) if has_w else None
    got = fused.fused_pass(_t(x), w=w, trim=trim, **stages)
    want = _jax_fused(m, k, d, mode, trim, bool(stages.get("pairwise")),
                      bool(stages.get("combine")), has_w)
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "pairwise":
            _dist_close(got[key].numpy(), want[key], x, off_diagonal=True)
        else:
            np.testing.assert_allclose(got[key].numpy(), want[key], **TOL)


@pytest.mark.parametrize("bad,err", [
    (dict(), "at least one"),
    (dict(reduce="nosuch"), "unknown reduce mode"),
    (dict(combine=True), "needs weights"),
])
def test_fused_pass_validates_requests(bad, err):
    with pytest.raises(ValueError, match=err):
        fused.fused_pass(_t(_stack(4, 16, 0)), **bad)


@pytest.mark.parametrize("call,err", [
    (lambda x: fused.pairwise_sqdist(torch.zeros(65, 8)), ValueError),
    (lambda x: fused.cross_sqdist(x, torch.zeros(1, 7)), ValueError),
    (lambda x: fused.cross_sqdist(x, x.to(torch.bfloat16)), ValueError),
    (lambda x: fused.weighted_combine(x, torch.ones(1, 5)), ValueError),
    (lambda x: fused.weighted_combine(x, torch.ones(65, 4)), ValueError),
    (lambda x: fused.weighted_combine(x, torch.ones(2, 4, dtype=torch.float64)),
     TypeError),
    (lambda x: fused.combine_reduce(x, torch.ones(2, 4), "nosuch"), ValueError),
    (lambda x: fused.pairwise_sqdist(x.double()), TypeError),
])
def test_wrappers_reject(call, err):
    with pytest.raises(err):
        call(_t(_stack(4, 8, 1)))


def test_wrappers_on_cpu_launch_nothing():
    x, w = _t(_stack(17, 300, 2)), _t(_weights(17, 17, 2))
    before = dict(fused.LAUNCHES)
    torch.testing.assert_close(fused.pairwise_sqdist(x),
                               kref.pairwise_sqdist_ref(x), rtol=0, atol=0)
    torch.testing.assert_close(fused.cross_sqdist(x, x[:1]),
                               kref.cross_sqdist_ref(x, x[:1]), rtol=0, atol=0)
    torch.testing.assert_close(fused.weighted_combine(x, w),
                               kref.weighted_combine_ref(x, w), rtol=0, atol=0)
    torch.testing.assert_close(fused.combine_reduce(x, w, "tm", 8),
                               kref.combine_reduce_ref(x, w, "tm", 8),
                               rtol=0, atol=0)
    assert fused.LAUNCHES == before


def test_kernel_backend_on_cpu_raises():
    x = _t(_stack(5, 8, 4))
    for call in (lambda: t_engine.pairwise_sqdist(x, backend="kernel"),
                 lambda: t_engine.cross_sqdist(x, x[:1], backend="kernel"),
                 lambda: t_engine.weighted_combine(x, x[:, 0], backend="kernel"),
                 lambda: t_engine.combine_reduce(x, x[:, :5], "med",
                                                 backend="kernel")):
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ------------------------------------------------- tree primitives


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_tree_primitives_match_jax(backend):
    m = 9
    stk = _tree(m, 0)
    z = {k: v[0] + 0.01 for k, v in stk.items()}
    w1 = _weights(1, m, 1)[0]
    wm = _weights(m, m, 2)
    jt = {k: jnp.asarray(v) for k, v in stk.items()}
    tt = {k: _t(v) for k, v in stk.items()}
    _dist_close(t_engine.tree_pairwise_sqdist(tt).numpy(),
                j_engine.tree_pairwise_sqdist(jt, backend=backend),
                np.concatenate([v.reshape(m, -1) for v in stk.values()], 1))
    _dist_close(t_engine.tree_cross_sqdist(tt, {k: _t(v) for k, v in z.items()})
                .numpy()[:, None],
                np.asarray(j_engine.tree_cross_sqdist(
                    jt, {k: jnp.asarray(v) for k, v in z.items()},
                    backend=backend))[:, None],
                np.concatenate([v.reshape(m, -1) for v in stk.values()], 1))
    _close_tree(t_engine.tree_weighted_combine(tt, _t(w1)),
                j_engine.tree_weighted_combine(jt, jnp.asarray(w1),
                                               backend=backend))
    _close_tree(t_engine.tree_weighted_combine(tt, _t(wm)),
                j_engine.tree_weighted_combine(jt, jnp.asarray(wm),
                                               backend=backend))
    for mode, trim in [("med", 0), ("tm", 3), ("mean", 0)]:
        _close_tree(t_engine.tree_combine_reduce(tt, _t(wm), mode=mode, trim=trim),
                    j_engine.tree_combine_reduce(jt, jnp.asarray(wm), mode=mode,
                                                 trim=trim, backend=backend))


def test_tree_weighted_combine_out_dtype():
    stk = {k: _t(v, bf16=True) for k, v in _tree(5, 1).items()}
    w = _t(_weights(1, 5, 0)[0])
    assert all(v.dtype == torch.bfloat16
               for v in t_engine.tree_weighted_combine(stk, w).values())
    assert all(v.dtype == torch.float32 for v in t_engine.tree_weighted_combine(
        stk, w, out_dtype=torch.float32).values())


# ------------------------------------------------- weight cores


def _tied_d2(m, seed):
    """A symmetric distance matrix of small integers: many exact ties."""
    a = np.random.default_rng(seed).integers(1, 4, size=(m, m)).astype(np.float32)
    d2 = np.triu(a, 1)
    return d2 + d2.T


@pytest.mark.parametrize("seed", range(4))
def test_weight_cores_break_ties_as_jax(seed):
    m = 9
    d2 = _tied_d2(m, seed)
    for k, multi in [(1, 1), (4, 1), (6, 3)]:
        np.testing.assert_array_equal(
            t_rules._krum_weights(_t(d2), k, multi).numpy(),
            np.asarray(j_rules._krum_weights(jnp.asarray(d2), k, multi)))
    for k in (1, 4, 9):
        np.testing.assert_array_equal(
            t_rules._nnm_weights(_t(d2), k).numpy(),
            np.asarray(j_rules._nnm_weights(jnp.asarray(d2), k)))
    for tau in (1.5, 2.5, 4.0, 100.0):
        np.testing.assert_array_equal(
            t_rules._mfm_weights(_t(d2), tau).numpy(),
            np.asarray(j_rules._mfm_weights(jnp.asarray(d2), tau)))


def test_mfm_without_majority_gives_zero():
    d2 = np.full((6, 6), 100.0, np.float32)
    np.fill_diagonal(d2, 0.0)
    np.testing.assert_array_equal(t_rules._mfm_weights(_t(d2), 1.0).numpy(),
                                  np.zeros(6, np.float32))


# ------------------------------------------------- rules


RULES = [("krum", {}), ("krum", {"multi": 3}), ("geomed", {}),
         ("geomed", {"iters": 3, "eps": 1e-6}), ("nnm+mean", {}),
         ("nnm+cwmed", {}), ("nnm+cwtm", {}), ("nnm+krum", {}),
         ("mfm", {"tau": 4.0})]


@functools.cache
def _jax_rule(name, kw, backend, m, seed, far):
    agg = j_rules.get_aggregator(name, delta=0.3, backend=backend, **dict(kw))
    out = agg.tree({k: jnp.asarray(v) for k, v in _tree(m, seed, far).items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("name,kw", RULES, ids=lambda v: str(v))
def test_rule_tree_matches_jax(name, kw, backend):
    m, seed, far = 11, 3, (1, 4, 8)
    agg = t_engine.get_aggregator(name, delta=0.3, **kw)
    got = agg.tree({k: _t(v) for k, v in _tree(m, seed, far).items()})
    _close_tree(got, _jax_rule(name, tuple(sorted(kw.items())), backend, m,
                               seed, far))


def test_rules_pick_the_near_workers():
    """Krum's pick and MFM's mean come from the near workers only."""
    m, far = 11, (1, 4, 8)
    stk = _tree(m, 3, far)
    near = [i for i in range(m) if i not in far]
    krum = t_engine.get_aggregator("krum", delta=0.3).tree(
        {k: _t(v) for k, v in stk.items()})
    assert any(all(np.array_equal(krum[k].numpy(), stk[k][i]) for k in stk)
               for i in near)
    mfm = t_engine.get_aggregator("mfm", tau=4.0).tree(
        {k: _t(v) for k, v in stk.items()})
    for k in stk:
        np.testing.assert_allclose(mfm[k].numpy(), stk[k][near].mean(0), **TOL)


def test_get_aggregator_kwargs_and_errors():
    krum = t_engine.get_aggregator("KRUM", delta=0.2, multi=3)
    assert (krum.name, krum.delta, krum.multi) == ("krum", 0.2, 3)
    geo = t_engine.get_aggregator("geomed", iters=3, eps=1e-6)
    assert (geo.iters, geo.eps) == (3, 1e-6)
    nnm = t_engine.get_aggregator("nnm+cwtm", delta=0.3)
    assert nnm.name == "nnm+cwtm" and nnm.base.delta == 0.3 == nnm.delta
    assert t_engine.get_aggregator("mfm", tau=2.0).tau == 2.0
    assert t_engine.get_aggregator("krum") is t_engine.get_aggregator("krum")
    assert t_engine.registered_rules() == j_engine.registered_rules()
    with pytest.raises(TypeError):
        t_engine.get_aggregator("krum", iters=3)
    with pytest.raises(ValueError, match="unknown aggregator"):
        t_engine.get_aggregator("nnm+nosuch")
    with pytest.raises(ValueError, match="threshold"):
        t_engine.get_aggregator("mfm").tree({"a": torch.zeros(3, 2)})


def test_kappa_and_diagnostic_helpers_match_jax():
    for name, f in j_rules.KAPPA.items():
        for d in (0.1, 0.3, 0.5):
            assert t_rules.KAPPA[name](d, 9) == f(d, 9)
    assert sorted(t_rules.KAPPA) == sorted(j_rules.KAPPA)
    stk = _tree(6, 4)
    jt = {k: jnp.asarray(v) for k, v in stk.items()}
    tt = {k: _t(v) for k, v in stk.items()}
    mat = t_rules.tree_stack_to_mat(tt)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(j_rules.tree_stack_to_mat(jt)))
    back = t_rules.mat_to_tree(mat[2], tt)
    want = j_rules.mat_to_tree(jnp.asarray(mat[2].numpy()), jt)
    _close_tree(back, want, rtol=0, atol=0)
    _dist_close(t_rules.pairwise_sqdists(mat).numpy(),
                j_rules.pairwise_sqdists(jnp.asarray(mat.numpy())), mat.numpy())
    _dist_close(t_rules.tree_pairwise_sqdists(tt).numpy(),
                j_rules.tree_pairwise_sqdists(jt), mat.numpy())
