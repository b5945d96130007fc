"""The launch planner of the combine kernels (``kernels/fused.py::
combine_plan``, ``combine_plan_fits``, ``tree_launches``), pure functions
that run on the CPU: every column of every leaf falls in exactly one block,
no block is empty, a tree of more leaves than one launch takes splits into
the right launches, and every k gets a plan ``combine.cu`` takes for every
m. Also the tree wrappers' CPU path and argument checks. The kernel itself
is held to its plain version on the card, in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused
from repro_torch.kernels import ref as kref

MAX = fused.MAX_LEAVES
TREES = {
    "main": (128, 10, 8192, 1280),
    "one": (9610,),
    "narrow": (1, 2, 3, 31, 32, 33, 63, 64, 65),
    "empty_leaves": (0, 5, 0, 0, 70, 0),
    "many": tuple(1 + (37 * i) % 97 for i in range(MAX + 9)),
    "many_empty": tuple((0 if i % 3 == 0 else 1 + i) for i in range(3 * MAX)),
}


def _blocks_of(widths, cols):
    """Every (leaf, column range) each block of each launch takes, found the
    way the kernel finds it: the last leaf whose first block is <= b."""
    seen = []
    for leaves, firsts, blocks in fused.tree_launches(widths, cols):
        assert 1 <= len(leaves) <= MAX
        assert firsts[0] == 0 and list(firsts) == sorted(firsts)
        for b in range(blocks):
            pos = max(q for q in range(len(leaves)) if firsts[q] <= b)
            leaf = leaves[pos]
            lo = (b - firsts[pos]) * cols
            seen.append((leaf, lo, min(lo + cols, widths[leaf])))
    return seen


@pytest.mark.parametrize("cols", [32, 64, 128, 256])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_every_column_in_exactly_one_block(tree, cols):
    widths = TREES[tree]
    hits = [np.zeros(d, dtype=np.int64) for d in widths]
    for leaf, lo, hi in _blocks_of(widths, cols):
        assert lo < hi, "a block with no column"
        hits[leaf][lo:hi] += 1
    for h in hits:
        assert (h == 1).all()


@pytest.mark.parametrize("n,sizes", [(1, [1]), (31, [31]), (32, [32]),
                                     (33, [32, 1]), (64, [32, 32]),
                                     (65, [32, 32, 1]), (100, [32, 32, 32, 4])])
def test_trees_split_into_launches_of_at_most_max_leaves(n, sizes):
    widths = tuple(1 + i % 60 for i in range(n))
    launches = fused.tree_launches(widths, 64)
    assert [len(l.leaves) for l in launches] == sizes
    assert [i for l in launches for i in l.leaves] == list(range(n))
    assert all(l.blocks == len(l.leaves) for l in launches)  # d <= 64: one block


def test_empty_leaves_take_no_launch():
    assert fused.tree_launches((0, 0, 0), 64) == ()
    (launch,) = fused.tree_launches(TREES["empty_leaves"], 32)
    assert launch.leaves == (1, 4) and launch.first_blocks == (0, 1)
    assert launch.blocks == 4
    many = TREES["many_empty"]
    assert [len(l.leaves) for l in fused.tree_launches(many, 64)] == [32, 32]


def test_main_path_tree_is_one_launch():
    (launch,) = fused.tree_launches(TREES["main"], 64)
    assert launch == fused.TreeLaunch((0, 1, 2, 3), (0, 2, 3, 131), 151)


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("k", range(1, fused.MAX_ROWS + 1))
def test_plan_fits_every_m(k, reduce):
    plan = fused.combine_plan(k, reduce)
    for m in range(1, fused.MAX_ROWS + 1):
        assert fused.combine_plan_fits(plan, m, k), (plan, m)
    groups = -(-k // plan.rows_per_thread)
    assert groups * plan.cols_per_block <= fused.combine_max_threads(k)


def test_plan_at_main_path_shapes():
    """GeoMed, Krum and MFM combine at k = 1; NNM mixes and reduces at
    k = m = 17."""
    assert fused.combine_plan(1) == fused.combine_plan(1, True) == (1, 64)
    assert fused.combine_plan(17) == (3, 32)
    assert fused.combine_plan(17, True) == (6, 32)
    assert fused.combine_plan(64) == fused.combine_plan(64, True) == (8, 32)


@pytest.mark.parametrize("plan,m,k", [
    ((4, 64), 17, 17),  # no instance of 4 rows a thread
    ((3, 48), 17, 17),  # not a power of two of columns
    ((3, 96), 17, 17),
    ((3, 16), 17, 17),  # less than a warp
    ((1, 32), 17, 17),  # 17 groups of 32 threads: over the bound of 512
    ((6, 64), 64, 64),  # 11 groups of 64: over the bound of 256 above k = 32
    ((8, 256), 64, 17),  # 3 groups of 256 threads: over 512
])
def test_plan_fits_rejects(plan, m, k):
    assert not fused.combine_plan_fits(fused.CombinePlan(*plan), m, k)


def test_plan_fits_counts_shared_memory():
    # (3 groups * 8 rows * 64 + 64 * 128) floats = 38 KB fits; 256 columns
    # would not fit the thread bound anyway, 128 at m = k = 64 passes 48 KB
    assert fused.combine_plan_fits(fused.CombinePlan(8, 128), 64, 17)
    assert not fused.combine_plan_fits(fused.CombinePlan(8, 256), 64, 8)


@pytest.mark.parametrize("k", [0, 65, -1])
def test_plan_rejects_k(k):
    with pytest.raises(ValueError):
        fused.combine_plan(k)


def test_plan_is_pure():
    """The same plans from the cache and computed afresh."""
    cached = [fused.combine_plan(k, r) for k in (1, 17, 64) for r in (0, 1)]
    fused.combine_plan.cache_clear()
    assert [fused.combine_plan(k, r) for k in (1, 17, 64) for r in (0, 1)] == cached


# ------------------------------------------------- the tree wrappers on the CPU


def _leaves(m, widths, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dtype)
            for d in widths]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tree_wrappers_on_cpu_are_the_plain_versions(k, dtype):
    xs = _leaves(5, (7, 1, 0, 12), k, dtype)
    w = torch.from_numpy(np.random.default_rng(9).random((k, 5)).astype(np.float32))
    before = dict(fused.LAUNCHES)
    ys = fused.tree_weighted_combine(xs, w)
    for x, y in zip(xs, ys):
        want = kref.weighted_combine_ref(x, w)
        assert y.shape == ((x.shape[1],) if k == 1 else (k, x.shape[1]))
        assert torch.equal(y.reshape(want.shape), want)
        assert torch.equal(y.reshape(want.shape), fused.weighted_combine(x, w))
    for mode, trim in [("med", 0), ("tm", 1), ("tm", 9), ("mean", 0)]:
        reds = fused.tree_combine_reduce(xs, w, mode, trim)
        for x, red in zip(xs, reds):
            want = kref.combine_reduce_ref(x, w, mode, min(trim, (k - 1) // 2))
            assert torch.equal(red, want)
            assert torch.equal(red, fused.combine_reduce(x, w, mode, trim))
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("call,err", [
    (lambda xs, w: fused.tree_weighted_combine([], w), ValueError),
    (lambda xs, w: fused.tree_weighted_combine([xs[0], xs[1][:4]], w), ValueError),
    (lambda xs, w: fused.tree_weighted_combine(
        [xs[0], xs[1].to(torch.bfloat16)], w), ValueError),
    (lambda xs, w: fused.tree_weighted_combine([xs[0], xs[1].T], w), ValueError),
    (lambda xs, w: fused.tree_weighted_combine([xs[0], xs[1].double()], w),
     TypeError),
    (lambda xs, w: fused.tree_weighted_combine(xs, w[:, :4]), ValueError),
    (lambda xs, w: fused.tree_weighted_combine(xs, torch.ones(65, 5)), ValueError),
    (lambda xs, w: fused.tree_combine_reduce(xs, w, "nosuch"), ValueError),
    (lambda xs, w: fused.tree_combine_reduce(
        [xs[0], torch.empty(5, 3, device="meta")], w, "med"), ValueError),
])
def test_tree_wrappers_reject(call, err):
    xs = _leaves(5, (6, 5), 3)
    w = torch.ones(2, 5)
    with pytest.raises(err):
        call(xs, w)


@pytest.mark.parametrize("k", [1, 5, 9])
@pytest.mark.parametrize("trim", [-2, 0, 2, 4, 100])
def test_combine_reduce_tensor_trim_is_the_int_trim(k, trim):
    """K5's trim as an integer tensor (the sweep's NNM+CWTM lanes read it on
    the card) gives, on the CPU, the bits of the int trim clipped to
    [0, (k-1)//2]."""
    rng = np.random.default_rng(k)
    xs = [torch.from_numpy(rng.normal(size=(9, d)).astype(np.float32))
          for d in (5, 1, 12)]
    w = torch.from_numpy(rng.random((k, 9)).astype(np.float32))
    want = fused.tree_combine_reduce(xs, w, "tm", min(max(trim, 0), (k - 1) // 2))
    for dtype in (torch.int32, torch.int64):
        t = torch.tensor(trim, dtype=dtype)
        for a, b in zip(fused.tree_combine_reduce(xs, w, "tm", t), want):
            assert torch.equal(a, b)
        assert torch.equal(fused.combine_reduce(xs[0], w, "tm", t), want[0])
    with pytest.raises(TypeError):
        fused.tree_combine_reduce(xs, w, "tm", torch.tensor([1, 2]))
