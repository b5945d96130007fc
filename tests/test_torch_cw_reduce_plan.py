"""The launch plan of the coordinate-wise reduce (``kernels/fused.py::
cw_reduce_plan``, ``cw_reduce_plan_fits``, and ``tree_launches`` at its
columns a block), pure functions that run on the CPU: every column of every
leaf falls in exactly one block at every plan ``cw_reduce.cu`` takes, a tree
of more leaves than one launch takes splits into launches of at most 32,
empty leaves take no launch, and the main path's tree is one launch. Also
``tree_cw_reduce`` on the CPU against the per-leaf plain versions (bit for
bit) and against the JAX package's ``CoordinateWiseRule.tree`` on its ref
backend and its Pallas kernel in interpret mode (as tests/test_torch_kernels.py
runs it), at that file's rtol = atol = 1e-5, with the trim a value and a
tensor, clipped when out of range.

The kernel itself is held to its plain version on the card, in
tests/test_torch_cuda.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agg_engine as j_engine
from repro.core import aggregators as j_rules
from repro_torch.core import agg_engine as t_engine
from repro_torch.kernels import fused
from repro_torch.kernels import ref as kref

TOL = dict(rtol=1e-5, atol=1e-5)
MAX = fused.MAX_LEAVES
TREES = {
    "main": (8192, 1280, 128, 10),
    "one": (9610,),
    "narrow": (1, 2, 3, 31, 32, 33, 63, 64, 65),
    "empty_leaves": (0, 5, 0, 0, 70, 0),
    "many": tuple(1 + (37 * i) % 97 for i in range(MAX + 9)),
    "many_empty": tuple((0 if i % 3 == 0 else 1 + i) for i in range(3 * MAX)),
}


def _plans(m):
    """Every plan cw_reduce.cu takes for m rows."""
    return [p for lanes in fused.CW_REDUCE_LANES for cols in (16, 32, 64, 128, 256)
            if fused.cw_reduce_plan_fits(p := fused.CwReducePlan(lanes, cols), m)]


@pytest.mark.parametrize("m", [1, 2, 17, 64])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_every_column_in_exactly_one_block(tree, m):
    widths = TREES[tree]
    for plan in _plans(m) + [fused.cw_reduce_plan(m)]:
        cols = plan.cols_per_block
        hits = [np.zeros(d, dtype=np.int64) for d in widths]
        for leaves, firsts, blocks in fused.tree_launches(widths, cols):
            assert 1 <= len(leaves) <= MAX
            for b in range(blocks):  # the kernel's walk: the last first <= b
                pos = max(q for q in range(len(leaves)) if firsts[q] <= b)
                leaf = leaves[pos]
                lo = (b - firsts[pos]) * cols
                hi = min(lo + cols, widths[leaf])
                assert lo < hi, "a block with no column"
                hits[leaf][lo:hi] += 1
        for h in hits:
            assert (h == 1).all(), plan


@pytest.mark.parametrize("n,sizes", [(1, [1]), (32, [32]), (33, [32, 1]),
                                     (65, [32, 32, 1]), (100, [32, 32, 32, 4])])
def test_trees_split_into_launches_of_at_most_max_leaves(n, sizes):
    widths = tuple(1 + i % 60 for i in range(n))
    launches = fused.tree_launches(widths, fused.cw_reduce_plan(17).cols_per_block)
    assert [len(l.leaves) for l in launches] == sizes
    assert [i for l in launches for i in l.leaves] == list(range(n))


def test_empty_leaves_take_no_launch():
    cols = fused.cw_reduce_plan(17).cols_per_block
    assert fused.tree_launches((0, 0), cols) == ()
    (launch,) = fused.tree_launches(TREES["empty_leaves"], cols)
    assert launch.leaves == (1, 4)
    many = TREES["many_empty"]
    assert [len(l.leaves) for l in fused.tree_launches(many, cols)] == [32, 32]
    outs = fused.tree_cw_reduce([torch.zeros(5, 0), torch.ones(5, 3)], "med")
    assert outs[0].shape == (0,) and torch.equal(outs[1], torch.ones(3))


def test_main_path_tree_is_one_launch():
    plan = fused.cw_reduce_plan(17)
    (launch,) = fused.tree_launches(TREES["main"], plan.cols_per_block)
    assert launch.leaves == (0, 1, 2, 3)
    assert launch.blocks == sum(-(-d // plan.cols_per_block) for d in TREES["main"])
    assert launch.blocks >= 132  # at least one block per SM of the H100


@pytest.mark.parametrize("m", range(1, fused.MAX_ROWS + 1))
def test_plan_fits_every_m(m):
    plan = fused.cw_reduce_plan(m)
    assert fused.cw_reduce_plan_fits(plan, m)
    assert plan.lanes <= 1 << (m - 1).bit_length()


@pytest.mark.parametrize("plan,m", [
    ((3, 32), 17),  # no instance of 3 lanes
    ((4, 32), 17),  # nor of 4
    ((2, 8), 17),  # 16 threads: not a whole warp
    ((1, 512), 17),  # over the launch bound of 256
    ((2, 256), 17),
    ((2, 32), 1),  # more lanes than rows
    ((1, 0), 17),
])
def test_plan_fits_rejects(plan, m):
    assert not fused.cw_reduce_plan_fits(fused.CwReducePlan(*plan), m)


@pytest.mark.parametrize("m", [0, 65, -1])
def test_plan_rejects_m(m):
    with pytest.raises(ValueError):
        fused.cw_reduce_plan(m)


def test_plan_is_pure():
    """The same plans from the cache and computed afresh."""
    cached = [fused.cw_reduce_plan(m) for m in range(1, 65)]
    fused.cw_reduce_plan.cache_clear()
    fused.tree_launches.cache_clear()
    assert [fused.cw_reduce_plan(m) for m in range(1, 65)] == cached


# ------------------------------------------------- the tree reduce on the CPU


def _leaves(m, widths, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dtype)
            for d in widths]


@pytest.mark.parametrize("m", [1, 4, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tree_on_cpu_is_the_plain_versions(m, dtype):
    xs = _leaves(m, (7, 1, 0, 12), m, dtype)
    before = dict(fused.LAUNCHES)
    for mode, trim in [("med", 0), ("mean", 0), ("tm", 0), ("tm", 2),
                       ("tm", torch.tensor(2)), ("tm", torch.tensor([1], dtype=torch.int32))]:
        outs = fused.tree_cw_reduce(xs, mode, trim)
        for x, out in zip(xs, outs):
            assert out.shape == (x.shape[1],) and out.dtype == torch.float32
            assert torch.equal(out, kref.cw_reduce_ref(x, mode, trim))
            assert torch.equal(out, fused.cw_reduce(x, mode, trim))
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("trim", [-3, -1, 0, 3, 4, 5, 100])
def test_out_of_range_trims_clip_as_a_value_does(trim):
    """A trim tensor out of [0, (m-1)//2] clips as an int trim does, in the
    wrapper and in agg_engine on the ref backend; 4 and above keep the
    median row of 9."""
    xs = _leaves(9, (6, 11), 40)
    want = fused.tree_cw_reduce(xs, "tm", min(max(trim, 0), 4))
    for t in (trim, torch.tensor(trim), torch.tensor(trim, dtype=torch.int32)):
        for a, b in zip(fused.tree_cw_reduce(xs, "tm", t), want):
            assert torch.equal(a, b)
    if trim >= 4:
        for a, x in zip(want, xs):
            assert torch.equal(a, kref.cwmed_ref(x))
    stacked = dict(zip("ab", xs))
    got = t_engine.tree_cw_reduce(stacked, "tm", torch.tensor(trim), backend="ref")
    for key, w in zip("ab", want):
        assert torch.equal(got[key], w)


@pytest.mark.parametrize("call,err", [
    (lambda xs: fused.tree_cw_reduce([], "med"), ValueError),
    (lambda xs: fused.tree_cw_reduce(xs, "nosuch"), ValueError),
    (lambda xs: fused.tree_cw_reduce([xs[0], xs[1][:4]], "med"), ValueError),
    (lambda xs: fused.tree_cw_reduce([xs[0], xs[1].to(torch.bfloat16)], "med"),
     ValueError),
    (lambda xs: fused.tree_cw_reduce([xs[0], xs[1].T], "med"), ValueError),
    (lambda xs: fused.tree_cw_reduce([xs[0].double()], "med"), TypeError),
    (lambda xs: fused.tree_cw_reduce([torch.zeros(65, 3)], "med"), ValueError),
    (lambda xs: fused.tree_cw_reduce(
        [xs[0], torch.empty(5, 3, device="meta")], "med"), ValueError),
    (lambda xs: fused.tree_cw_reduce(xs, "tm", torch.ones(2, dtype=torch.int32)),
     TypeError),
    (lambda xs: fused.tree_cw_reduce(xs, "tm", torch.tensor(2.0)), TypeError),
])
def test_tree_rejects(call, err):
    with pytest.raises(err):
        call(_leaves(5, (6, 5), 3))


# ------------------------------------------------- against the JAX package

SHAPES = {"b1": (7,), "b2": (3,), "w1": (5, 7), "w2": (7, 3)}
M_JAX, DELTA = 11, 0.3  # trim_count(0.3, 11) = 4


@functools.cache
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(M_JAX,) + s) * 3.0).astype(np.float32)
            for k, s in SHAPES.items()}


@functools.cache
def _jax_leaf_results(rule, backend, bf16):
    """The per-leaf float32 results of the JAX rule's tree (its ``_reduce``
    of each leaf as a float32 matrix, before the cast back to the leaf's
    dtype), in sorted key order."""
    agg = j_rules.get_aggregator(rule, delta=DELTA, backend=backend)
    out = []
    for k in sorted(SHAPES):
        leaf = jnp.asarray(_tree(1)[k])
        if bf16:
            leaf = leaf.astype(jnp.bfloat16)
        out.append(np.asarray(agg._reduce(j_engine._as_mat(leaf))))
    return out


RULE_MODES = {"cwmed": "med", "cwtm": "tm", "mean": "mean"}


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("rule", sorted(RULE_MODES))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tree_matches_jax_rule(rule, backend, bf16):
    """The port's tree reduce of a 4-leaf tree, the trim of CWTM a value and
    a tensor, against the JAX rule's per-leaf results; on float32 leaves the
    port's rule ``tree`` against the JAX rule's ``tree`` too."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    leaves = {k: torch.from_numpy(v).to(dtype) for k, v in _tree(1).items()}
    mats = [leaves[k].reshape(M_JAX, -1).contiguous() for k in sorted(SHAPES)]
    mode = RULE_MODES[rule]
    trim = t_engine.trim_count(DELTA, M_JAX)
    assert trim == j_engine.trim_count(DELTA, M_JAX) == 4
    want = _jax_leaf_results(rule, backend, bf16)
    trims = [trim, torch.tensor(trim, dtype=torch.int32)] if mode == "tm" else [0]
    for t in trims:
        for got, w in zip(fused.tree_cw_reduce(mats, mode, t), want):
            np.testing.assert_allclose(got.numpy(), w, **TOL)
    if not bf16:
        agg = j_rules.get_aggregator(rule, delta=DELTA, backend=backend)
        j_out = agg.tree({k: jnp.asarray(v) for k, v in _tree(1).items()})
        t_out = t_engine.get_aggregator(rule, delta=DELTA).tree(leaves)
        for k in SHAPES:
            assert t_out[k].shape == leaves[k].shape[1:]
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), **TOL)


@pytest.mark.parametrize("trim", [0, 2, 4, 9, -1])
def test_traced_trim_matches_jax_masked_kernel(trim):
    """A trim tensor against the JAX package's traced-trim Pallas kernel
    (``cwtm_masked`` in interpret mode) on the same leaf, with JAX's trim
    clipped as the port clips it (the JAX kernel takes it as given)."""
    x = _tree(2)["w1"].reshape(M_JAX, -1)
    clipped = min(max(trim, 0), (M_JAX - 1) // 2)
    want = np.asarray(j_engine.cw_trimmed_mean(jnp.asarray(x), jnp.int32(clipped),
                                               backend="pallas"))
    got = fused.tree_cw_reduce([torch.from_numpy(x)], "tm",
                               torch.tensor(trim, dtype=torch.int32))[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------ the lanes of a sweep


@pytest.mark.parametrize("stacks", [1, 2, 8, 17])
@pytest.mark.parametrize("tree", ["main", "narrow", "empty_leaves", "many"])
def test_lane_launches_take_stacks_blocks_a_leaf(tree, stacks):
    """A leaf of ``stacks`` stacks takes stacks * ceil(d / cols) blocks,
    numbered on from the leaves before it; one stack is the plain plan."""
    widths, cols = TREES[tree], 64
    one, many = fused.tree_launches(widths, cols), fused.tree_launches(
        widths, cols, stacks)
    assert [l.leaves for l in many] == [l.leaves for l in one]
    for a, b in zip(one, many):
        assert b.first_blocks == tuple(stacks * f for f in a.first_blocks)
        assert b.blocks == stacks * a.blocks
    if stacks == 1:
        assert many == one


@pytest.mark.parametrize("C", [1, 3, 8])
def test_lanes_on_cpu_are_one_tree_call_a_lane(C):
    """``tree_cw_reduce_lanes`` on the CPU: (C, d) outputs, row c bitwise
    the ``tree_cw_reduce`` of lane c, with a trim for every lane or one a
    lane (a tensor of C integers, clipped); ``agg_engine``'s lane form on
    the plain backend likewise; no launch is counted."""
    m = 9
    xs = [torch.stack(_leaves(m, (w,) * C, 5 * C + w)) for w in (7, 1, 12)]
    trims = [(-2, 0, 3, 100, 4, 1)[c % 6] for c in range(C)]
    before = dict(fused.LAUNCHES)
    for mode, trim in [("med", 0), ("mean", 0), ("tm", 3),
                       ("tm", torch.tensor(trims, dtype=torch.int32))]:
        outs = fused.tree_cw_reduce_lanes(xs, mode, trim)
        stacked = dict(zip("abc", xs))
        via_engine = t_engine.tree_cw_reduce_lanes(stacked, mode, trim,
                                                   backend="ref")
        for x, out, key in zip(xs, outs, "abc"):
            assert out.shape == (C, x.shape[2])
            assert torch.equal(via_engine[key], out)
        for c in range(C):
            t_c = trims[c] if torch.is_tensor(trim) else trim
            for out, o in zip(outs, fused.tree_cw_reduce([x[c] for x in xs],
                                                         mode, t_c)):
                assert torch.equal(out[c], o), (mode, c)
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("call,err", [
    (lambda: fused.tree_cw_reduce_lanes([], "tm"), ValueError),
    (lambda: fused.tree_cw_reduce_lanes([torch.zeros(3, 4)], "tm"), ValueError),
    (lambda: fused.tree_cw_reduce_lanes(
        [torch.zeros(2, 3, 4), torch.zeros(3, 3, 4)], "tm"), ValueError),
    (lambda: fused.tree_cw_reduce_lanes(
        [torch.zeros(2, 4, 3).transpose(1, 2)], "tm"), ValueError),
    (lambda: fused.tree_cw_reduce_lanes(
        [torch.zeros(2, 3, 4)], "tm", torch.tensor([1, 2, 3])), TypeError),
    (lambda: fused.tree_cw_reduce_lanes(
        [torch.zeros(2, 3, 4)], "tm", torch.tensor([1.0, 2.0])), TypeError),
    (lambda: fused.tree_cw_reduce_lanes([torch.zeros(2, 3, 4)], "x"), ValueError),
])
def test_lanes_reject(call, err):
    with pytest.raises(err):
        call()
