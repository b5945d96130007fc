"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; this file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol = atol = 1e-5 for the reduce and combine kernels (they sum
in row order, the plain versions in torch's order). The distance kernels
are held to atol 2e-6 after dividing both sides by the larger of the
largest distance and the largest squared row norm: the Gram expansion
cancels relative to the row norms, so at m = 1 the only distance is that
cancellation residue.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import agg_engine
from repro_torch.kernels import fused
from repro_torch.kernels import ref as kref

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)
GEOMETRY_M = [1, 2, 3, 16, 17, 32, 64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _stack(m, d, seed, dtype):
    x = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _dist_close(got, want, *rows):
    """Distances equal where not finite, and within atol 2e-6 of each other
    after scaling by the largest finite distance or squared row norm."""
    got, want = got.cpu(), want.cpu()
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    torch.testing.assert_close(got[~finite], want[~finite], equal_nan=True,
                               rtol=0, atol=0)
    norms = torch.cat([r.float().square().sum(1).cpu() for r in rows])
    norms = norms[torch.isfinite(norms)]
    scale = max(float(want[finite].max()) if finite.any() else 0.0,
                float(norms.max()) if norms.numel() else 0.0, 1e-30)
    torch.testing.assert_close(got[finite] / scale, want[finite] / scale,
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("m", [1, 2, 3, 17, 32, 33, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain(cuda_device, m, dtype):
    x = _stack(m, 9610, m, dtype)
    xd = x.to(cuda_device)
    before = fused.LAUNCHES["cw_reduce"]
    cases = [("med", 0), ("mean", 0), ("tm", 0), ("tm", (m - 1) // 2)]
    for mode, trim in cases:
        got = fused.cw_reduce(xd, mode, trim).cpu()
        torch.testing.assert_close(got, fused.cw_reduce(x, mode, trim), **TOL)
    assert fused.LAUNCHES["cw_reduce"] == before + len(cases)


def test_masked_trim_on_card(cuda_device):
    xd = _stack(17, 1000, 0, torch.float32).to(cuda_device)
    for trim in range(9):
        t = torch.tensor(trim, device=cuda_device)
        torch.testing.assert_close(fused.cwtm_masked(xd, t), fused.cwtm(xd, trim),
                                   rtol=0, atol=0)


def test_nan_column_and_outlier_on_card(cuda_device):
    x = _stack(17, 300, 1, torch.float32)
    x[0] = 1e30
    x[4, 7] = float("nan")
    xd = x.to(cuda_device)
    for mode in fused.REDUCE_MODES:
        got = fused.cw_reduce(xd, mode, 8).cpu()
        assert torch.isnan(got[7])
        torch.testing.assert_close(got, fused.cw_reduce(x, mode, 8),
                                   equal_nan=True, **TOL)


# ------------------------------------------------- geometry kernels


@pytest.mark.parametrize("m", GEOMETRY_M)
@pytest.mark.parametrize("d", [10, 777, 9610])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_distances_match_plain(cuda_device, m, d, dtype):
    x = _stack(m, d, 10 + m, dtype)
    y = _stack(2, d, 20 + m, dtype)
    xd, yd = x.to(cuda_device), y.to(cuda_device)
    before = dict(fused.LAUNCHES)
    pw = fused.pairwise_sqdist(xd)
    _dist_close(pw, kref.pairwise_sqdist_ref(x), x)
    assert torch.equal(pw, pw.T)
    _dist_close(fused.cross_sqdist(xd, yd[:1]), kref.cross_sqdist_ref(x, y[:1]),
                x, y)
    _dist_close(fused.cross_sqdist(xd, yd), kref.cross_sqdist_ref(x, y), x, y)
    assert fused.LAUNCHES["pairwise_sqdist"] == before["pairwise_sqdist"] + 1
    assert fused.LAUNCHES["cross_sqdist"] == before["cross_sqdist"] + 2


@pytest.mark.parametrize("m", GEOMETRY_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_combine_matches_plain(cuda_device, m, dtype):
    x = _stack(m, 9610, 30 + m, dtype)
    xd = x.to(cuda_device)
    rng = np.random.default_rng(m)
    for k in sorted({1, m}):
        w = torch.from_numpy(rng.random((k, m)).astype(np.float32))
        wd = w.to(cuda_device)
        before = dict(fused.LAUNCHES)
        torch.testing.assert_close(fused.weighted_combine(xd, wd).cpu(),
                                   kref.weighted_combine_ref(x, w), **TOL)
        cases = [("med", 0), ("mean", 0), ("tm", 0), ("tm", (k - 1) // 2)]
        for mode, trim in cases:
            torch.testing.assert_close(
                fused.combine_reduce(xd, wd, mode, trim).cpu(),
                kref.combine_reduce_ref(x, w, mode, trim), **TOL)
        assert fused.LAUNCHES["weighted_combine"] == before["weighted_combine"] + 1
        assert (fused.LAUNCHES["combine_reduce"]
                == before["combine_reduce"] + len(cases))


def test_fused_pass_stage_subsets_on_card(cuda_device):
    x = _stack(17, 2000, 3, torch.float32)
    w = torch.from_numpy(np.random.default_rng(3).random((17, 17)).astype(
        np.float32))
    xd, wd = x.to(cuda_device), w.to(cuda_device)
    for stages in [dict(pairwise=True), dict(combine=True),
                   dict(reduce="tm", trim=8), dict(reduce="med", combine=True),
                   dict(reduce="mean", pairwise=True, combine=True)]:
        got = fused.fused_pass(xd, w=wd, **stages)
        want = fused.fused_pass(x, w=w, **stages)
        assert sorted(got) == sorted(want)
        for key in want:
            if key == "pairwise":
                _dist_close(got[key], want[key], x)
            else:
                torch.testing.assert_close(got[key].cpu(), want[key], **TOL)


def test_geometry_edge_inputs_on_card(cuda_device):
    x = _stack(17, 9610, 4, torch.float32)
    x[0] = 1e30
    x[5, 3] = float("nan")
    xd = x.to(cuda_device)
    z = x[1:2].clone()
    _dist_close(fused.pairwise_sqdist(xd), kref.pairwise_sqdist_ref(x), x)
    _dist_close(fused.cross_sqdist(xd, z.to(cuda_device)),
                kref.cross_sqdist_ref(x, z), x, z)
    w = torch.full((17, 17), 1.0 / 17)
    for mode in fused.REDUCE_MODES:
        got = fused.combine_reduce(xd, w.to(cuda_device), mode, 8).cpu()
        assert torch.isnan(got[3])
        torch.testing.assert_close(got, kref.combine_reduce_ref(x, w, mode, 8),
                                   equal_nan=True, **TOL)


def test_distances_rerun_bitwise(cuda_device):
    xd = _stack(17, 9610, 5, torch.float32).to(cuda_device)
    assert torch.equal(fused.pairwise_sqdist(xd), fused.pairwise_sqdist(xd))
    assert torch.equal(fused.cross_sqdist(xd, xd[:1]),
                       fused.cross_sqdist(xd, xd[:1]))


# ------------------------------------------------- sqdist.cu: one launch


def _one_block_max_d(n_pairs):
    """The largest d that ``sqdist_plan`` gives one block for n_pairs."""
    d = fused.SQDIST_UNIT
    while fused.sqdist_plan(n_pairs, d + fused.SQDIST_UNIT).blocks == 1:
        d += fused.SQDIST_UNIT
    return d


def _plain_f64(x, y=None):
    """The plain versions' formulas (``kref``) evaluated in float64 on the
    card and rounded to float32 once: the reference where d is so wide that
    the float32 plain version's own rounding (its row norms and its Gram
    diagonal are two different float32 sums) reaches 2e-6 of the squared
    norms."""
    x = x.double()
    if y is None:
        sq = (x * x).sum(1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    else:
        y = y.double()
        d2 = torch.stack([((x - y[j]) ** 2).sum(1) for j in range(y.shape[0])], 1)
    return d2.clamp(min=0.0).float()


def _sqdist_case(kernel, m, d, dtype, seed=0):
    """(kernel call, reference, rows) of one distance kernel, both on the
    card."""
    k = {"pairwise": 0, "cross_k1": 1, "cross_k3": 3}[kernel]
    xd = _stack(m, d, seed, dtype).to("cuda")
    if k == 0:
        return lambda: fused.pairwise_sqdist(xd), _plain_f64(xd), (xd,)
    yd = _stack(k, d, seed + 1, dtype).to("cuda")
    return lambda: fused.cross_sqdist(xd, yd), _plain_f64(xd, yd), (xd, yd)


@pytest.mark.parametrize("kernel", ["pairwise", "cross_k1", "cross_k3"])
@pytest.mark.parametrize("d_case", ["1", "3", "10", "one_block",
                                    "one_block+1", "9610", "2^20"])
@pytest.mark.parametrize("m", [1, 2, 17, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sqdist_plan_edges_on_card(cuda_device, kernel, d_case, m, dtype):
    """Every edge of the block planner: one chunk, a ragged chunk, rows that
    are not 16-byte aligned (odd d; d % 4 != 0 for f32, % 8 for bf16), the
    largest d of one block and one column more (the first two-block plan),
    the main path's flat d and 2^20 (the 132-block cap). Held to the plain
    formulas in float64 at the usual 2e-6: at d = 2^20 the float32 plain
    version's diagonal residue alone is 3-4e-6 of the squared norm (bf16
    rows, measured on an NVIDIA H100), where the kernel's diagonal is
    exactly 0. Bitwise equal on rerun."""
    n_pairs = {"pairwise": m * (m + 1) // 2, "cross_k1": m,
               "cross_k3": 3 * m}[kernel]
    one = _one_block_max_d(n_pairs)
    d = {"one_block": one, "one_block+1": one + 1, "2^20": 1 << 20}.get(
        d_case) or int(d_case)
    plan = fused.sqdist_plan(n_pairs, d)
    if d_case == "one_block":
        assert plan.blocks == 1
    if d_case == "one_block+1":
        assert plan.blocks == 2
    if d_case == "2^20":
        assert plan.blocks == fused.SQDIST_MAX_BLOCKS
    kern, want, rows = _sqdist_case(kernel, m, d, dtype, seed=m + d)
    got = kern()
    _dist_close(got, want, *rows)
    assert torch.equal(got, kern()), "rerun differs"
    if kernel == "pairwise":
        assert torch.equal(got, got.T)
        assert not got.diagonal().any()


@pytest.mark.parametrize("d", [12, 1280, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sqdist_unaligned_base_on_card(cuda_device, d, dtype):
    """A stack whose first row starts 1 element past a 16-byte boundary,
    with d a multiple of 8: the kernel takes its scalar path."""
    x = _stack(17, d, d, dtype)
    y = _stack(2, d, d + 1, dtype)
    buf = torch.zeros(17 * d + 1, dtype=dtype, device=cuda_device)
    xd = buf[1:].view(17, d)
    xd.copy_(x)
    ybuf = torch.zeros(2 * d + 1, dtype=dtype, device=cuda_device)
    yd = ybuf[1:].view(2, d)
    yd.copy_(y)
    assert xd.data_ptr() % 16 and yd.data_ptr() % 16
    _dist_close(fused.pairwise_sqdist(xd), kref.pairwise_sqdist_ref(x), x)
    _dist_close(fused.cross_sqdist(xd, yd), kref.cross_sqdist_ref(x, y), x, y)
    _dist_close(fused.cross_sqdist(xd, yd[:1]), kref.cross_sqdist_ref(x, y[:1]),
                x, y)


@pytest.mark.parametrize("d", [10, 128, 1280, 9610])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sqdist_nan_and_outlier_rows_on_card(cuda_device, d, dtype):
    """A 1e30 row and a row with a NaN, on one-block and many-block plans:
    the same non-finite entries as the plain versions."""
    x = _stack(17, d, 7, dtype)
    x[0] = 1e30
    x[5, d // 2] = float("nan")
    z = _stack(1, d, 8, dtype)
    xd, zd = x.to(cuda_device), z.to(cuda_device)
    pw = fused.pairwise_sqdist(xd)
    assert torch.isnan(pw[5]).all() and torch.isnan(pw[:, 5]).all()
    _dist_close(pw, kref.pairwise_sqdist_ref(x), x)
    cross = fused.cross_sqdist(xd, zd)
    assert torch.isnan(cross[5]).all()
    _dist_close(cross, kref.cross_sqdist_ref(x, z), x, z)
    _dist_close(fused.cross_sqdist(zd, xd), kref.cross_sqdist_ref(z, x), x, z)


def test_sqdist_graph_replay_bitwise(cuda_device):
    """A CUDA graph of 8 calls (one-block and many-block plans of both
    kernels), replayed twice, gives the eager calls' bits: the counter is
    back at 0 after every call."""
    xs = [_stack(17, d, 40 + d, torch.float32).to(cuda_device)
          for d in (10, 8192, 1280, 9610)]
    zs = [x[:1].clone() for x in xs]

    def calls():
        outs = []
        for x, z in zip(xs, zs):
            outs += [fused.pairwise_sqdist(x), fused.cross_sqdist(x, z)]
        return outs

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    assert len(captured) == 8
    for _ in range(2):
        for out in captured:
            out.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
    assert torch.equal(calls()[1], eager[1])  # eager again after the replays


def test_sqdist_two_streams(cuda_device):
    """Calls alternating between two streams, then calls running at once on
    both: each stream has its own counter, so every result keeps its bits."""
    xs = [_stack(17, 8192 + 64 * i, 50 + i, torch.float32).to(cuda_device)
          for i in range(4)]
    want = [(fused.pairwise_sqdist(x), fused.cross_sqdist(x, x[:1]))
            for x in xs]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for i, x in enumerate(xs):  # alternating
        with torch.cuda.stream(s1 if i % 2 else s2):
            got.append((fused.pairwise_sqdist(x), fused.cross_sqdist(x, x[:1])))
    torch.cuda.synchronize()
    for (a, b), (c, e) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, e)
    big = [_stack(64, 1 << 18, 60 + i, torch.float32).to(cuda_device)
           for i in range(2)]
    big_want = [fused.pairwise_sqdist(x) for x in big]
    torch.cuda.synchronize()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):  # at once: 132 blocks on each stream
        outs = []
        for s, x in zip((s1, s2), big):
            with torch.cuda.stream(s):
                outs.append([fused.pairwise_sqdist(x) for _ in range(4)])
        torch.cuda.synchronize()
        for o, w in zip(outs, big_want):
            assert all(torch.equal(v, w) for v in o)


def test_sqdist_one_launch_per_call(cuda_device):
    """Each call of either kernel is one CUDA kernel on the card, on a
    one-block and on a many-block plan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for d in (10, 8192):
        x = _stack(17, d, 70, torch.float32).to(cuda_device)
        for call in (lambda: fused.pairwise_sqdist(x),
                     lambda: fused.cross_sqdist(x, x[:1])):
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            assert len(kernels) == 1, [e.name for e in kernels]
            assert "sqdist_kernel" in kernels[0].name


@pytest.mark.parametrize("name", ["krum", "geomed", "nnm+cwtm", "nnm+mean",
                                  "nnm+krum", "mfm"])
def test_rules_on_card_match_plain(cuda_device, name):
    """12 workers near one point and 5 far from it, so that every rule's
    choices (Krum's pick, NNM's neighbours, MFM's filter) are clear-cut."""
    rng = np.random.default_rng(6)
    shapes = {"b1": (128,), "b2": (10,), "w1": (64, 128), "w2": (128, 10)}
    far = np.isin(np.arange(17), [2, 5, 8, 11, 14])
    stacked = {}
    for k, s in shapes.items():
        v = rng.normal(size=s) + 0.1 * rng.normal(size=(17,) + s)
        v[far] += 5.0
        stacked[k] = torch.from_numpy(v.astype(np.float32))
    kw = dict(tau=40.0) if name == "mfm" else {}
    want = agg_engine.get_aggregator(name, delta=0.3, backend="ref", **kw).tree(
        stacked)
    got = agg_engine.get_aggregator(name, delta=0.3, backend="kernel", **kw).tree(
        {k: v.to(cuda_device) for k, v in stacked.items()})
    for k in shapes:
        torch.testing.assert_close(got[k].cpu(), want[k], **TOL)


# ------------------------------------------------- combine.cu: one launch a tree

# leaf widths: the main path's tree, one leaf, more leaves than one launch
# takes (widths 1 to 97, some not a multiple of 4), and narrow odd widths
TREES = {"main": (8192, 1280, 128, 10), "one": (777,),
         "many": tuple(1 + (37 * i) % 97 for i in range(fused.MAX_LEAVES + 9)),
         "odd": (1, 3, 5, 7, 13, 130, 0, 6)}


def _leaves(m, widths, seed, dtype):
    return [_stack(m, d, seed + i, dtype) for i, d in enumerate(widths)]


def _tree_weights(k, m, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((k, m)).astype(
        np.float32))


def _launches_per_call(widths):
    return -(-sum(1 for d in widths if d) // fused.MAX_LEAVES)


@pytest.mark.parametrize("k,m", [(1, 17), (17, 17), (64, 64)])
@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tree_combine_matches_plain_and_leaves(cuda_device, k, m, tree, dtype):
    """A tree launch within 1e-5 of the plain version of every leaf, and
    bitwise equal to one launch per leaf; launches counted per tree call."""
    widths = TREES[tree]
    xs = _leaves(m, widths, 100 + k, dtype)
    xds = [x.to(cuda_device) for x in xs]
    w = _tree_weights(k, m, k)
    wd = w.to(cuda_device)
    per_call = _launches_per_call(widths)
    before = dict(fused.LAUNCHES)
    got = fused.tree_weighted_combine(xds, wd)
    assert fused.LAUNCHES["weighted_combine"] == before["weighted_combine"] + per_call
    for x, xd, y in zip(xs, xds, got):
        assert y.shape == ((x.shape[1],) if k == 1 else (k, x.shape[1]))
        one = fused.weighted_combine(xd, wd)
        assert torch.equal(y.reshape(one.shape), one)
        torch.testing.assert_close(y.reshape(one.shape).cpu(),
                                   kref.weighted_combine_ref(x, w), **TOL)
    for mode, trim in [("med", 0), ("mean", 0), ("tm", 0), ("tm", 8),
                       ("tm", (k - 1) // 2)]:
        before = fused.LAUNCHES["combine_reduce"]
        got = fused.tree_combine_reduce(xds, wd, mode, trim)
        assert fused.LAUNCHES["combine_reduce"] == before + per_call
        for x, xd, red in zip(xs, xds, got):
            assert torch.equal(red, fused.combine_reduce(xd, wd, mode, trim))
            torch.testing.assert_close(
                red.cpu(), kref.combine_reduce_ref(x, w, mode, min(trim, (k - 1) // 2)),
                **TOL)


@pytest.mark.parametrize("k,m", [(1, 17), (17, 17), (64, 64), (5, 3)])
def test_every_combine_plan_gives_the_same_bits(cuda_device, k, m):
    """Every plan combine.cu takes (each instance of rows a thread, 32 to
    256 columns a block) gives the default plan's bits, written y and
    reduce in one pass too."""
    xds = [x.to(cuda_device) for x in _leaves(m, TREES["odd"], 7, torch.float32)]
    wd = _tree_weights(k, m, 3).to(cuda_device)
    want = fused._combine(xds, wd, "tm", 1, True, "test")
    tried = 0
    for r in fused.COMBINE_ROWS:
        for cols in (32, 64, 128, 256):
            plan = fused.CombinePlan(r, cols)
            if not fused.combine_plan_fits(plan, m, k):
                continue
            got = fused._combine(xds, wd, "tm", 1, True, "test", plan=plan)
            for a, b in zip(got[0] + got[1], want[0] + want[1]):
                assert torch.equal(a, b), plan
            tried += 1
    assert tried >= (1 if k > 32 else 3)  # above 32 only (8, 32) fits


def test_tree_nan_and_outlier_on_card(cuda_device):
    """A 1e30 row and a NaN in one leaf of the tree: the NaN column is NaN in
    that leaf only, as the plain versions give it."""
    xs = _leaves(17, TREES["main"], 9, torch.float32)
    xs[1][0] = 1e30
    xs[1][5, 3] = float("nan")
    xds = [x.to(cuda_device) for x in xs]
    w = torch.full((17, 17), 1.0 / 17)
    for mode in fused.REDUCE_MODES:
        got = fused.tree_combine_reduce(xds, w.to(cuda_device), mode, 8)
        assert torch.isnan(got[1][3]) and not torch.isnan(got[0]).any()
        for x, red in zip(xs, got):
            torch.testing.assert_close(red.cpu(), kref.combine_reduce_ref(x, w, mode, 8),
                                       equal_nan=True, **TOL)
    ys = fused.tree_weighted_combine(xds, w.to(cuda_device))
    assert torch.isnan(ys[1][:, 3]).all()


def test_tree_unaligned_leaves_on_card(cuda_device):
    """Leaves that start 1 element past a 16-byte boundary, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        xs = _leaves(17, (8, 1280, 12), 11, dtype)
        xds = []
        for x in xs:
            buf = torch.zeros(x.numel() + 1, dtype=dtype, device=cuda_device)
            xd = buf[1:].view(x.shape)
            xd.copy_(x)
            xds.append(xd)
        w = _tree_weights(17, 17, 4)
        got = fused.tree_combine_reduce(xds, w.to(cuda_device), "med")
        for x, red in zip(xs, got):
            torch.testing.assert_close(red.cpu(), kref.combine_reduce_ref(x, w, "med"),
                                       **TOL)


def _tree_calls(xds, w1, wm):
    return (fused.tree_weighted_combine(xds, w1)
            + fused.tree_weighted_combine(xds, wm)
            + fused.tree_combine_reduce(xds, wm, "tm", 8))


def test_tree_graph_replay_bitwise(cuda_device):
    """A CUDA graph of three tree calls, replayed twice, gives the eager
    calls' bits."""
    xds = [x.to(cuda_device) for x in _leaves(17, TREES["main"], 12, torch.float32)]
    w1 = _tree_weights(1, 17, 5).to(cuda_device)
    wm = _tree_weights(17, 17, 6).to(cuda_device)
    eager = _tree_calls(xds, w1, wm)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _tree_calls(xds, w1, wm)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _tree_calls(xds, w1, wm)
    for _ in range(2):
        for out in captured:
            out.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


def test_tree_two_streams(cuda_device):
    """Tree calls running at once on two streams keep their bits."""
    trees = [[x.to(cuda_device) for x in _leaves(17, TREES["main"], 20 + 4 * i,
                                                  torch.float32)]
             for i in range(2)]
    w1 = _tree_weights(1, 17, 7).to(cuda_device)
    wm = _tree_weights(17, 17, 8).to(cuda_device)
    want = [_tree_calls(xds, w1, wm) for xds in trees]
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        outs = []
        for s, xds in zip((s1, s2), trees):
            with torch.cuda.stream(s):
                outs.append([_tree_calls(xds, w1, wm) for _ in range(4)])
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert all(torch.equal(a, b) for calls in o for a, b in zip(calls, w))


@pytest.mark.parametrize("tree", ["main", "many"])
def test_tree_one_launch_per_call(cuda_device, tree):
    """One CUDA kernel per tree call (two for a tree of more leaves than a
    launch takes), for both tree forms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    widths = TREES[tree]
    xds = [x.to(cuda_device) for x in _leaves(17, widths, 13, torch.float32)]
    wm = _tree_weights(17, 17, 9).to(cuda_device)
    for call in (lambda: fused.tree_weighted_combine(xds, wm[:1]),
                 lambda: fused.tree_combine_reduce(xds, wm, "tm", 8)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(kernels) == _launches_per_call(widths), [e.name for e in kernels]
        assert all("combine_kernel" in e.name for e in kernels)


def test_agg_engine_tree_forms_one_launch_on_card(cuda_device):
    """agg_engine's tree forms on the kernel backend: one launch a call,
    the leaves' shapes and dtypes, and the plain backend's values."""
    rng = np.random.default_rng(14)
    shapes = {"b1": (128,), "b2": (10,), "w1": (64, 128), "w2": (128, 10)}
    stacked = {k: torch.from_numpy(rng.normal(size=(17,) + s).astype(np.float32))
               for k, s in shapes.items()}
    on_card = {k: v.to(cuda_device) for k, v in stacked.items()}
    w1 = torch.full((17,), 1.0 / 17)
    wm = _tree_weights(17, 17, 10)
    before = dict(fused.LAUNCHES)
    cases = [
        (agg_engine.tree_weighted_combine(on_card, w1.to(cuda_device), backend="kernel"),
         agg_engine.tree_weighted_combine(stacked, w1, backend="ref")),
        (agg_engine.tree_weighted_combine(on_card, wm.to(cuda_device), backend="kernel"),
         agg_engine.tree_weighted_combine(stacked, wm, backend="ref")),
        (agg_engine.tree_combine_reduce(on_card, wm.to(cuda_device), mode="tm", trim=8,
                                        backend="kernel"),
         agg_engine.tree_combine_reduce(stacked, wm, mode="tm", trim=8, backend="ref"))]
    assert fused.LAUNCHES["weighted_combine"] == before["weighted_combine"] + 2
    assert fused.LAUNCHES["combine_reduce"] == before["combine_reduce"] + 1
    for got, want in cases:
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape
            assert got[key].dtype == want[key].dtype
            torch.testing.assert_close(got[key].cpu(), want[key], **TOL)


# ------------------------------------------------- cw_reduce.cu: one launch a tree

CW_TREES = {"main": (8192, 1280, 128, 10), "one": (9610,),
            "many": TREES["many"], "odd": (1, 3, 5, 7, 13, 130, 0, 1282)}


def _cw_cases(m, dev):
    return ([("med", 0), ("mean", 0)]
            + [("tm", t) for t in sorted({0, 8, (m - 1) // 2})]
            + [("tm", torch.tensor(8, dtype=torch.int32, device=dev))])


@pytest.mark.parametrize("m", [2, 17, 33, 64])
@pytest.mark.parametrize("tree", sorted(CW_TREES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tree_cw_reduce_matches_plain_and_leaves(cuda_device, m, tree, dtype):
    """A tree launch within 1e-5 of the plain version of every leaf and
    bitwise equal to one launch per leaf, the trim a value or an int32 on
    the card; launches counted per tree call."""
    widths = CW_TREES[tree]
    xs = _leaves(m, widths, 200 + m, dtype)
    xds = [x.to(cuda_device) for x in xs]
    per_call = _launches_per_call(widths)
    for mode, trim in _cw_cases(m, cuda_device):
        before = fused.LAUNCHES["cw_reduce"]
        got = fused.tree_cw_reduce(xds, mode, trim)
        assert fused.LAUNCHES["cw_reduce"] == before + per_call
        for x, xd, out in zip(xs, xds, got):
            assert out.shape == (x.shape[1],) and out.dtype == torch.float32
            assert torch.equal(out, fused.cw_reduce(xd, mode, trim))
            torch.testing.assert_close(
                out.cpu(), kref.cw_reduce_ref(x, mode, trim.cpu() if torch.is_tensor(trim)
                                              else trim), **TOL)


@pytest.mark.parametrize("m", [1, 2, 3, 17, 64])
def test_every_cw_reduce_plan_gives_the_same_bits(cuda_device, m):
    """Every plan cw_reduce.cu takes (1 or 2 lanes a column, 16 to 256
    columns a block) gives the default plan's bits, in every mode, with a
    1e30 row and a NaN in the tree."""
    xs = _leaves(m, CW_TREES["odd"] + CW_TREES["main"], 21, torch.float32)
    xs[1][0] = 1e30
    xs[8][m // 2, 5] = float("nan")
    xds = [x.to(cuda_device) for x in xs]
    tried = 0
    for mode in fused.REDUCE_MODES:
        want = fused.tree_cw_reduce(xds, mode, 8)
        for lanes in fused.CW_REDUCE_LANES:
            for cols in (16, 32, 64, 128, 256):
                plan = fused.CwReducePlan(lanes, cols)
                if not fused.cw_reduce_plan_fits(plan, m):
                    continue
                got = fused.tree_cw_reduce(xds, mode, 8, plan=plan)
                for a, b in zip(got, want):  # as bits: NaN == NaN
                    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                        (plan, mode)
                tried += 1
    assert tried >= 3 * (4 if m == 1 else 8)


def test_tree_cw_reduce_nan_and_outlier_on_card(cuda_device):
    """A 1e30 row and a NaN in one leaf: the NaN column is NaN in that leaf
    only, as the plain versions give it."""
    xs = _leaves(17, CW_TREES["main"], 22, torch.float32)
    xs[1][0] = 1e30
    xs[1][5, 3] = float("nan")
    xds = [x.to(cuda_device) for x in xs]
    for mode in fused.REDUCE_MODES:
        got = fused.tree_cw_reduce(xds, mode, 8)
        assert torch.isnan(got[1][3]) and not torch.isnan(got[0]).any()
        for x, out in zip(xs, got):
            torch.testing.assert_close(out.cpu(), kref.cw_reduce_ref(x, mode, 8),
                                       equal_nan=True, **TOL)


def test_tree_cw_reduce_device_trim_clips(cuda_device):
    """A trim on the card out of range clips as a value does, in int32 and
    in int64 (cast on the card)."""
    xds = [x.to(cuda_device) for x in _leaves(9, (50, 3), 23, torch.float32)]
    for trim in (-5, -1, 0, 2, 4, 5, 1000):
        want = fused.tree_cw_reduce(xds, "tm", trim)
        for dtype in (torch.int32, torch.int64):
            t = torch.tensor(trim, dtype=dtype, device=cuda_device)
            for a, b in zip(fused.tree_cw_reduce(xds, "tm", t), want):
                assert torch.equal(a, b), (trim, dtype)


def test_cwtm_masked_makes_no_host_sync(cuda_device):
    """cwtm_masked and the tree form with an int32 trim on the card run
    under set_sync_debug_mode("error"), which raises on a host sync."""
    xd = _stack(17, 9610, 24, torch.float32).to(cuda_device)
    xds = [x.to(cuda_device) for x in _leaves(17, CW_TREES["main"], 25,
                                              torch.float32)]
    t = torch.tensor(8, dtype=torch.int32, device=cuda_device)
    fused.cwtm_masked(xd, t)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fused.cwtm_masked(xd, t)
        tree = agg_engine.tree_cw_reduce(
            dict(zip("abcd", xds)), "tm", t, backend="kernel")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, fused.cwtm(xd, 8))
    for key, x in zip("abcd", xds):
        assert torch.equal(tree[key], fused.cwtm(x, 8))


def test_tree_cw_reduce_graph_replay_with_trim_changed(cuda_device):
    """A CUDA graph of tree calls (trim a value, and on the card), replayed
    after the trim tensor changes in place, gives the eager calls' bits at
    the new trim."""
    xds = [x.to(cuda_device) for x in _leaves(17, CW_TREES["main"], 26,
                                              torch.float32)]
    t = torch.tensor(8, dtype=torch.int32, device=cuda_device)

    def calls():
        return (fused.tree_cw_reduce(xds, "tm", t)
                + fused.tree_cw_reduce(xds, "med")
                + fused.tree_cw_reduce(xds, "tm", 3))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for trim in (8, 0, 5, 100, -1, 8):
        t.fill_(trim)
        for out in captured:
            out.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        want = (fused.tree_cw_reduce(xds, "tm", trim)
                + fused.tree_cw_reduce(xds, "med")
                + fused.tree_cw_reduce(xds, "tm", 3))
        for got, w in zip(captured, want):
            assert torch.equal(got, w), trim


def test_tree_cw_reduce_two_streams(cuda_device):
    """Tree calls running at once on two streams keep their bits."""
    trees = [[x.to(cuda_device) for x in _leaves(17, CW_TREES["main"], 30 + 4 * i,
                                                  torch.float32)]
             for i in range(2)]
    t = torch.tensor(8, dtype=torch.int32, device=cuda_device)
    want = [fused.tree_cw_reduce(xds, "tm", t) for xds in trees]
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        outs = []
        for s, xds in zip((s1, s2), trees):
            with torch.cuda.stream(s):
                outs.append([fused.tree_cw_reduce(xds, "tm", t) for _ in range(4)])
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert all(torch.equal(a, b) for call in o for a, b in zip(call, w))


@pytest.mark.parametrize("tree", ["main", "many"])
def test_tree_cw_reduce_one_launch_per_call(cuda_device, tree):
    """One CUDA kernel per tree call (two for a tree of more leaves than a
    launch takes), the trim a value or an int32 on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    widths = CW_TREES[tree]
    xds = [x.to(cuda_device) for x in _leaves(17, widths, 27, torch.float32)]
    t = torch.tensor(8, dtype=torch.int32, device=cuda_device)
    for call in (lambda: fused.tree_cw_reduce(xds, "tm", 8),
                 lambda: fused.tree_cw_reduce(xds, "tm", t)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(kernels) == _launches_per_call(widths), [e.name for e in kernels]
        assert all("cw_reduce_kernel" in e.name for e in kernels)


@pytest.mark.parametrize("name", ["cwtm", "cwmed", "mean"])
def test_coordinate_wise_rules_one_launch_a_tree(cuda_device, name):
    """The coordinate-wise rules' tree on the kernel backend: one launch a
    call, the leaves' shapes and dtypes, the plain backend's values."""
    rng = np.random.default_rng(28)
    shapes = {"b1": (128,), "b2": (10,), "w1": (64, 128), "w2": (128, 10)}
    stacked = {k: torch.from_numpy(rng.normal(size=(17,) + s).astype(np.float32))
               for k, s in shapes.items()}
    before = fused.LAUNCHES["cw_reduce"]
    got = agg_engine.get_aggregator(name, delta=8 / 17 + 1e-3, backend="kernel").tree(
        {k: v.to(cuda_device) for k, v in stacked.items()})
    assert fused.LAUNCHES["cw_reduce"] == before + 1
    want = agg_engine.get_aggregator(name, delta=8 / 17 + 1e-3, backend="ref").tree(
        stacked)
    for key in shapes:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
        torch.testing.assert_close(got[key].cpu(), want[key], **TOL)


# ------------------------------------------ the compiled driver: CUDA graphs

FIG1 = dict(m=17, n_byz=8, K=10, delta=8 / 17 + 1e-3)
SCAN_LIMITS = {"cwtm": 1e-6, "geomed": 1e-5}  # chip_smoke's scan_path limits


def _fig1(dev, rule="cwtm", attack="sign_flip", kwargs=None):
    from repro_torch import DynaBROConfig, MLMCConfig, make_task
    task = make_task(FIG1["m"], seed=0, device=dev)
    cfg = DynaBROConfig(
        mlmc=MLMCConfig(T=150, m=FIG1["m"], V=5.0, option=1, kappa=1.0,
                        j_cap=5),
        aggregator=rule, delta=FIG1["delta"], attack=attack,
        attack_kwargs=kwargs)
    return task, cfg


def _fig1_switcher():
    from repro_torch import get_switcher
    return get_switcher("periodic", FIG1["m"], n_byz=FIG1["n_byz"], K=FIG1["K"])


def _launch_counts(run):
    before = dict(fused.LAUNCHES)
    out = run()
    return out, {k: v - before[k] for k, v in fused.LAUNCHES.items()
                 if v != before[k]}


@pytest.mark.parametrize("rule", sorted(SCAN_LIMITS))
def test_scan_graphs_match_per_round_on_card(cuda_device, rule):
    """T=24 of the Figure-1 setting: the graph replays against the per-round
    driver, with the same round logs, evals and kernel launches."""
    from repro_torch import run_dynabro, run_dynabro_scan, sgd
    (params0, grad_fn, sampler, eval_fn), cfg = _fig1(cuda_device, rule)
    (p1, l1, e1), n1 = _launch_counts(lambda: run_dynabro(
        grad_fn, params0, sgd(0.1), cfg, _fig1_switcher(), sampler, 24,
        eval_fn=eval_fn, eval_every=12))
    (p2, l2, e2), n2 = _launch_counts(lambda: run_dynabro_scan(
        grad_fn, params0, sgd(0.1), cfg, _fig1_switcher(), sampler, 24,
        eval_fn=eval_fn, eval_every=12, chunk=5))
    assert [vars(l) for l in l1] == [vars(l) for l in l2]
    assert e1 == e2 and [t for t, _ in e2] == [12, 24]
    assert n1 == n2 and n1
    for k in p1:
        assert p2[k].device == p1[k].device and p2[k].shape == p1[k].shape
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=SCAN_LIMITS[rule])


def test_scan_graphs_reused_across_runs(cuda_device):
    from repro_torch import make_dynabro_scan_fn, run_dynabro_scan, sgd
    (params0, grad_fn, sampler, _), cfg = _fig1(cuda_device)
    scan_fn = make_dynabro_scan_fn(grad_fn, cfg, sgd(0.1))
    runs = []
    for _ in range(2):
        runs.append(_launch_counts(lambda: run_dynabro_scan(
            grad_fn, params0, sgd(0.1), cfg, _fig1_switcher(), sampler, 24,
            scan_fn=scan_fn)))
        if len(runs) == 1:
            captures = scan_fn.captures
            assert captures == len({l.level for l in runs[0][0][1]})
    assert scan_fn.captures == captures  # the second run captured nothing
    (pa, la, _), na = runs[0]
    (pb, lb, _), nb = runs[1]
    assert [vars(l) for l in la] == [vars(l) for l in lb] and na == nb
    for k in pa:
        assert torch.equal(pa[k], pb[k])


def test_random_draws_under_replay_equal_eager(cuda_device):
    """A round that only draws from the run's generator: the graph replays
    give the bits of the same draws made eagerly, round after round."""
    from repro_torch.core.robust_train import ScanFn

    def round_fn(carry, batch, mask, key, generator):
        noise = torch.randn((3, 1000), generator=generator, device=cuda_device)
        return ({"x": carry[0]["x"] + noise * (key + 1)}, carry[1]), None, None

    T, seed = 10, 123
    keys = np.arange(T) % 2
    carry = ({"x": torch.zeros((3, 1000), device=cuda_device)}, ())
    masks = np.zeros((T, 3), bool)

    def batches(a, b):
        return torch.zeros((b - a, 3), device=cuda_device)

    got, _, _ = ScanFn(round_fn, flags=False).run(
        carry, keys, masks, batches, [4, 7, 10], seed)
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    want = carry[0]["x"]
    for t in range(T):
        want = want + torch.randn((3, 1000), generator=gen,
                                  device=cuda_device) * (int(keys[t]) + 1)
    assert torch.equal(got["x"], want)


def test_scan_replay_loop_makes_no_host_sync(cuda_device, monkeypatch):
    """The replay loop runs under ``set_sync_debug_mode("error")``: a run
    passes, and a host sync put into the loop raises."""
    from repro_torch import run_dynabro_scan, sgd
    (params0, grad_fn, sampler, _), cfg = _fig1(cuda_device)

    def run():
        return run_dynabro_scan(grad_fn, params0, sgd(0.1), cfg,
                                _fig1_switcher(), sampler, 12)

    run()
    assert torch.cuda.get_sync_debug_mode() == 0
    replay = torch.cuda.CUDAGraph.replay

    def replay_and_sync(self):
        replay(self)
        float(torch.ones(1, device=cuda_device).sum())  # a read to the host

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", replay_and_sync)
    with pytest.raises(RuntimeError, match="synchroniz"):
        run()
    assert torch.cuda.get_sync_debug_mode() == 0  # restored


def test_capture_survives_graphs_in_a_reference_cycle(cuda_device):
    """An earlier run's graphs left in a reference cycle (as a stopped
    server and its thread leave a session) are not freed while a capture
    runs: the collector stays off during it, even set to run at every
    allocation, and is on again after the run. A CUDA graph freed
    mid-capture, on any thread, ends the capture with
    cudaErrorStreamCaptureInvalidated."""
    from repro_torch import make_dynabro_scan_fn, run_dynabro_scan, sgd
    (params0, grad_fn, sampler, _), cfg = _fig1(cuda_device)

    def run(scan_fn):
        return run_dynabro_scan(grad_fn, params0, sgd(0.1), cfg,
                                _fig1_switcher(), sampler, 12, scan_fn=scan_fn)

    class Cycle:
        pass

    old = Cycle()
    old.me, old.scan_fn = old, make_dynabro_scan_fn(grad_fn, cfg, sgd(0.1))
    p_old, logs_old, _ = run(old.scan_fn)
    assert old.scan_fn.captures
    gone = weakref.ref(old)
    del old
    scan_fn = make_dynabro_scan_fn(grad_fn, cfg, sgd(0.1))
    round_fn, seen = scan_fn.round_fn, []

    def watched_round(*args):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return round_fn(*args)

    scan_fn.round_fn = watched_round
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        p_new, logs_new, _ = run(scan_fn)
    finally:
        gc.set_threshold(*threshold)
    assert len(seen) == scan_fn.captures and scan_fn.captures
    assert not any(seen), seen
    assert gc.isenabled()
    gc.collect()
    assert gone() is None
    assert [vars(l) for l in logs_new] == [vars(l) for l in logs_old]
    for k in p_old:
        assert torch.equal(p_new[k], p_old[k])


def test_failed_capture_raises(cuda_device):
    """A round that reads a value back to the host runs eagerly (the
    warm-up) but cannot be captured: the compiled driver raises and does
    not run the rounds eagerly instead."""
    from repro_torch import make_dynabro_scan_fn, run_dynabro_scan, sgd
    (params0, grad_fn, sampler, _), cfg = _fig1(cuda_device)
    scan_fn = make_dynabro_scan_fn(grad_fn, cfg, sgd(0.1))
    round_fn = scan_fn.round_fn

    def syncing_round(*args):
        out = round_fn(*args)
        float(out[2])  # the correction norm to the host: refused in a capture
        return out

    scan_fn.round_fn = syncing_round
    with pytest.raises(RuntimeError, match="captur"):
        run_dynabro_scan(grad_fn, params0, sgd(0.1), cfg, _fig1_switcher(),
                         sampler, 4, scan_fn=scan_fn)
    assert scan_fn.captures == 0
    torch.cuda.synchronize()  # the card still takes work
    assert float(torch.ones(4, device=cuda_device).sum()) == 4.0


# ------------------------------------------- the sweep's lane forms (K1/K2, K5)

LANE_WIDTHS = [8192, 1280, 128, 10]


def _lane_trims(C, m):
    return [(-2, 0, 3, 100, (m - 1) // 2, 8, 1)[c % 7] for c in range(C)]


@pytest.mark.parametrize("C", [1, 3, 8, 17])
@pytest.mark.parametrize("m", [2, 17, 33, 64])
def test_lane_reduce_matches_plain_and_one_lane_launches(cuda_device, C, m):
    """One launch reduces every leaf of every lane: within 1e-5 of the plain
    version and bitwise one ``tree_cw_reduce`` a lane, a trim a lane on the
    card (out-of-range ones clip) or one for every lane, both dtypes."""
    trims = _lane_trims(C, m)
    t_dev = torch.tensor(trims, dtype=torch.int32, device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        xs = [torch.stack(_leaves(m, [d] * C, 31 * C + d, dtype)).to(cuda_device)
              for d in LANE_WIDTHS]
        for mode, trim in [("med", 0), ("mean", 0), ("tm", 8), ("tm", t_dev)]:
            before = fused.LAUNCHES["cw_reduce"]
            outs = fused.tree_cw_reduce_lanes(xs, mode, trim)
            assert fused.LAUNCHES["cw_reduce"] == before + 1
            for x, out in zip(xs, outs):
                assert out.shape == (C, x.shape[2])
                torch.testing.assert_close(
                    out.cpu(), kref.cw_reduce_lanes_ref(x.cpu(), mode, trim.cpu()
                                                        if torch.is_tensor(trim)
                                                        else trim), **TOL)
            for c in range(C):
                one = fused.tree_cw_reduce([x[c] for x in xs], mode,
                                           trims[c] if torch.is_tensor(trim) else trim)
                for out, o in zip(outs, one):
                    assert torch.equal(out[c], o), (mode, c)


@pytest.mark.parametrize("k", [17, 64])
def test_combine_reduce_trim_on_card_is_the_int_trim(cuda_device, k):
    xs = [x.to(cuda_device) for x in _leaves(k, LANE_WIDTHS, 3, torch.float32)]
    w = _tree_weights(k, k, 4).to(cuda_device)
    for trim in (-3, 0, 2, 8, (k - 1) // 2, 100):
        for dtype in (torch.int32, torch.int64):
            t = torch.tensor(trim, dtype=dtype, device=cuda_device)
            got = fused.tree_combine_reduce(xs, w, "tm", t)
            want = fused.tree_combine_reduce(xs, w, "tm", min(max(trim, 0),
                                                             (k - 1) // 2))
            for a, b in zip(got, want):
                assert torch.equal(a, b), (trim, dtype)


def test_lane_reduce_and_k5_are_one_kernel_a_call(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    xs = [torch.stack(_leaves(17, [d] * 8, d, torch.float32)).to(cuda_device)
          for d in LANE_WIDTHS]
    leaves = [x[0] for x in xs]
    t8 = torch.arange(8, dtype=torch.int32, device=cuda_device)
    t1 = torch.tensor(8, dtype=torch.int32, device=cuda_device)
    w = _tree_weights(17, 17, 5).to(cuda_device)
    for call in (lambda: fused.tree_cw_reduce_lanes(xs, "tm", t8),
                 lambda: fused.tree_combine_reduce(leaves, w, "tm", t1)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(names) == 1, names


def test_lane_reduce_and_k5_replay_with_trims_changed(cuda_device):
    xs = [torch.stack(_leaves(17, [d] * 8, d + 1, torch.float32)).to(cuda_device)
          for d in LANE_WIDTHS]
    leaves = [x[1] for x in xs]
    w = _tree_weights(17, 17, 6).to(cuda_device)
    t8 = torch.full((8,), 8, dtype=torch.int32, device=cuda_device)
    t1 = torch.tensor(8, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused.tree_cw_reduce_lanes(xs, "tm", t8)
        fused.tree_combine_reduce(leaves, w, "tm", t1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        lanes = fused.tree_cw_reduce_lanes(xs, "tm", t8)
        k5 = fused.tree_combine_reduce(leaves, w, "tm", t1)
    for step in range(4):
        trims = [(3 * c + 5 * step) % 12 - 2 for c in range(8)]
        t8.copy_(torch.tensor(trims, dtype=torch.int32))
        t1.fill_(trims[1])
        graph.replay()
        torch.cuda.synchronize()
        for c in range(8):
            for out, o in zip(lanes, fused.tree_cw_reduce(
                    [x[c] for x in xs], "tm", trims[c])):
                assert torch.equal(out[c], o), (step, c)
        for a, b in zip(k5, fused.tree_combine_reduce(
                leaves, w, "tm", min(max(trims[1], 0), 8))):
            assert torch.equal(a, b), step


# ------------------------------------------------- sessions and sweeps on the card


def test_graphs_capture_a_new_level_after_a_full_run(cuda_device):
    """A run whose levels the kept graphs lack captures them after a run
    that left the round indices at the end of the buffers."""
    from repro_torch import make_dynabro_scan_fn, run_dynabro, run_dynabro_scan, sgd
    (params0, grad_fn, sampler, _), cfg = _fig1(cuda_device)
    scan_fn = make_dynabro_scan_fn(grad_fn, cfg, sgd(0.1))
    runs = {}
    for T, seed in [(8, 0), (8, 5), (8, 11)]:
        runs[seed] = run_dynabro_scan(grad_fn, params0, sgd(0.1), cfg,
                                      _fig1_switcher(), sampler, T, seed=seed,
                                      scan_fn=scan_fn)
        want = run_dynabro(grad_fn, params0, sgd(0.1), cfg, _fig1_switcher(),
                           sampler, T, seed=seed)
        assert [vars(l) for l in runs[seed][1]] == [vars(l) for l in want[1]]
        for k in want[0]:
            assert torch.equal(runs[seed][0][k], want[0][k]), (seed, k)


@pytest.mark.parametrize("attack", ["sign_flip", "random"])
def test_session_steps_replay_the_run_graphs(cuda_device, attack):
    """``Session.step`` round by round on the card: the bits of ``run``, the
    run's graphs replayed (no capture), a fresh session's first steps
    capturing each level once."""
    from repro_torch import Task, build_session, sgd
    (params0, grad_fn, sampler, _), cfg = _fig1(
        cuda_device, attack=attack, kwargs={"scale": 10.0} if attack == "random"
        else None)
    task = Task(params0, grad_fn, lambda m: sampler, lambda p: 0.0)
    T = 24
    sess = build_session(cfg, task, opt=sgd(0.1), switcher=_fig1_switcher())
    p_run, logs, _ = sess.run(T)
    captures = sess.scan_fn.captures
    fresh = build_session(cfg, task, opt=sgd(0.1), switcher=_fig1_switcher())
    for s in (sess, fresh):
        carry = s.init_carry()
        sched = s.schedule(T)
        infos = []
        for t in range(T):
            carry, info = s.step(carry, s.round_inputs(sched, t))
            infos.append(info.failsafe_ok)
        for k in p_run:
            assert torch.equal(carry[0][k], p_run[k]), k
        assert infos == [l.failsafe_ok for l in logs]
    assert sess.scan_fn.captures == captures
    assert fresh.scan_fn.captures == len({l.level for l in logs})


def test_sweep_lanes_match_lone_runs_on_card(cuda_device):
    """T=24 of the Figure-1 setting: CWTM lanes under two attacks and two
    deltas (one ``cw_reduce`` launch an aggregation for all of them) and
    Krum/NNM+CWTM lanes, each against a lone compiled run; a second sweep
    with new deltas replays without a capture."""
    import dataclasses

    from repro_torch import (AggSpec, SweepSpec, Task, build_session,
                             get_switcher, run_dynabro_scan, sgd)
    (params0, grad_fn, sampler, _), cfg = _fig1(cuda_device)
    task = Task(params0, grad_fn, lambda m: sampler, lambda p: 0.0)
    T = 24
    sess = build_session(cfg, task, m=FIG1["m"], opt=sgd(0.1))
    sws = tuple(("periodic", {"n_byz": FIG1["n_byz"], "K": k}) for k in (10, 25) * 2)
    aggs = (("cwtm", {"delta": FIG1["delta"]}), ("cwtm", {"delta": 0.35}),
            ("krum", {"delta": FIG1["delta"]}), ("nnm+cwtm", {"delta": 0.35}))
    attacks = ("sign_flip", "ipm", "sign_flip", "ipm")
    before = dict(fused.LAUNCHES)
    cw_only = sess.sweep(SweepSpec(switchers=sws, attacks=attacks,
                                   aggregators=aggs[:2] * 2), T)
    launches = fused.LAUNCHES["cw_reduce"] - before["cw_reduce"]
    levels = [l.level for l in cw_only[0][1]]
    assert launches == sum(3 if 1 <= j <= cfg.mlmc.j_max else 1 for j in levels)
    fn = sess._lane_fns[(("sign_flip", "ipm"), ("cwtm",))]
    captures = fn.captures
    swapped = (aggs[1], aggs[0]) * 2
    again = sess.sweep(SweepSpec(switchers=sws, attacks=attacks,
                                 aggregators=swapped), T)
    assert fn.captures == captures  # the same lane groups: the same graphs
    mixed = sess.sweep(SweepSpec(switchers=sws, attacks=attacks, aggregators=aggs), T)
    for outs, specs in ((cw_only, aggs[:2] * 2), (mixed, aggs), (again, swapped)):
        for c, (p, logs) in enumerate(outs):
            spec = AggSpec.coerce(specs[c])
            lcfg = spec.apply_to(dataclasses.replace(cfg, attack=attacks[c]))
            p1, l1, _ = run_dynabro_scan(grad_fn, params0, sgd(0.1), lcfg,
                                         get_switcher("periodic", FIG1["m"],
                                                      **sws[c][1]),
                                         sampler, T)
            assert [vars(l) for l in logs] == [vars(l) for l in l1], c
            lim = 1e-6 if spec.rule == "cwtm" else 1e-5
            for k in p1:
                assert float((p[k] - p1[k]).abs().max()) <= lim, (c, k)


@pytest.mark.parametrize("attack", ["sign_flip", "random"])
def test_served_stream_equals_run_on_card(cuda_device, attack):
    """T=24 of the Figure-1 setting served from 17 worker threads (2 ms
    jitter): params and logs bitwise equal to ``Session.run``; each level's
    graph captured once, on the serve thread, the first capture with every
    worker thread alive; every round a replay under the sync check."""
    import threading

    from repro_torch import (AggregationServer, ServeConfig, SimulatedWorkers,
                             Task, build_session, sgd, worker_payloads)
    from repro_torch.core import robust_train as rt
    (params0, grad_fn, sampler, _), cfg = _fig1(
        cuda_device, attack=attack, kwargs={"scale": 10.0} if attack == "random"
        else None)
    task = Task(params0, grad_fn, lambda m: sampler, lambda p: 0.0)
    T = 24

    def session():
        return build_session(cfg, task, opt=sgd(0.1), switcher=_fig1_switcher())

    p_run, logs, _ = session().run(T)
    sess = session()
    payloads = worker_payloads(sess, T)
    captures, modes = [], []
    capture, replay = rt._LevelGraphs.capture, torch.cuda.CUDAGraph.replay

    def watched_capture(self, keys):
        alive = sum(t.is_alive() for t in threading.enumerate()
                    if t.name.startswith("serve-worker"))
        captures.append((threading.current_thread().name, list(keys), alive))
        capture(self, keys)

    def watched_replay(graph):
        modes.append(torch.cuda.get_sync_debug_mode())
        replay(graph)

    rt._LevelGraphs.capture = watched_capture
    torch.cuda.CUDAGraph.replay = watched_replay
    try:
        server = AggregationServer(sess, T, ServeConfig(lookahead_rounds=4))
        server.start()
        workers = SimulatedWorkers(server, payloads, jitter_s=0.002).start()
        assert workers.join(timeout=30.0) and not workers.failures
        assert server.join(timeout=30.0), server.snapshot()
    finally:
        rt._LevelGraphs.capture = capture
        torch.cuda.CUDAGraph.replay = replay
    server.close()
    assert server.error is None, server.error
    for k in p_run:
        assert torch.equal(server.params[k], p_run[k]), k
    assert [vars(l) for l in server.logs] == [vars(l) for l in logs]
    levels = sorted({l.level for l in logs})
    assert sorted(k for _, keys, _ in captures for k in keys) == levels
    assert all(name == "serve-loop" for name, _, _ in captures), captures
    assert captures[0][2] == FIG1["m"], captures
    assert len(modes) == T and set(modes) == {2}, modes  # 2: "error"


def _guarded_fig1(dev, **kw):
    from repro_torch import Task, build_session, sgd
    (params0, grad_fn, sampler, _), cfg = _fig1(dev)
    task = Task(params0, grad_fn, lambda m: sampler, lambda p: 0.0)
    return build_session(cfg, task, opt=sgd(0.1), switcher=_fig1_switcher(),
                         **kw)


def test_guarded_session_steady_state_on_card(cuda_device):
    """T=24 of the Figure-1 setting on a guarded session: the first run
    captures each level once, a second run under the guard captures
    nothing (bitwise equal); a fresh guarded session's steps capture each
    level at its first step and nothing after (bitwise the run)."""
    from repro_torch.core import robust_train as rt
    from repro_torch.lint import compile_count
    T = 24
    sess = _guarded_fig1(cuda_device, guard_recompiles=True)
    c0 = rt.capture_count()  # the first run may build the kernels too
    p1, logs, _ = sess.run(T)
    levels = sorted({l.level for l in logs})
    assert rt.capture_count() - c0 == len(levels) == sess.scan_fn.captures
    c0 = compile_count()
    p2, _, _ = sess.run(T)
    assert compile_count() == c0
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    fresh = _guarded_fig1(cuda_device, guard_recompiles=True)
    carry, sched, seen = fresh.init_carry(), fresh.schedule(T), set()
    for t in range(T):
        c0 = compile_count()
        carry, _ = fresh.step(carry, fresh.round_inputs(sched, t))
        level = int(sched.levels[t])
        assert compile_count() - c0 == (level not in seen), (t, level)
        seen.add(level)
    for k in p1:
        assert torch.equal(carry[0][k], p1[k]), k
    assert fresh.scan_fn.captures == len(levels)


def test_forced_recapture_raises_on_card(cuda_device):
    """A warmed guarded session whose graphs are dropped: a guarded run
    raises ``RecompileError`` naming its captures; a counting guard counts
    them without raising; an exception in a guarded block is not masked."""
    from repro_torch.lint import RecompileError, recompile_guard
    T = 24
    sess = _guarded_fig1(cuda_device, guard_recompiles=True)
    p1, logs, _ = sess.run(T)
    n = len({l.level for l in logs})
    sess.scan_fn.drop_graphs()
    with pytest.raises(RecompileError, match=f"{n} recompile"):
        sess.run(T)
    sess.scan_fn.drop_graphs()
    sess.guard_recompiles = False
    with recompile_guard("counted", action="count") as g:
        p2, _, _ = sess.run(T)
    assert g.count == n
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    sess.scan_fn.drop_graphs()
    with pytest.raises(RuntimeError, match="original"):
        with recompile_guard("raise-through") as g:
            sess.run(T)
            raise RuntimeError("original failure")
    assert g.count == n


def test_served_stream_under_the_env_guard_on_card(cuda_device, monkeypatch):
    """T=24 served from 17 worker threads into a session built with
    ``REPRO_RECOMPILE_GUARD=1``: no ``RecompileError``, each level captured
    once, params bitwise ``Session.run``'s."""
    from repro_torch import (AggregationServer, ServeConfig, SimulatedWorkers,
                             worker_payloads)
    from repro_torch.api.session import GUARD_ENV
    from repro_torch.lint import compile_count
    T = 24
    p_run, logs, _ = _guarded_fig1(cuda_device).run(T)
    monkeypatch.setenv(GUARD_ENV, "1")
    sess = _guarded_fig1(cuda_device)
    assert sess.guard_recompiles
    c0 = compile_count()
    server = AggregationServer(sess, T, ServeConfig(lookahead_rounds=4))
    server.start()
    workers = SimulatedWorkers(server, worker_payloads(sess, T),
                               jitter_s=0.002).start()
    assert workers.join(timeout=30.0) and not workers.failures
    assert server.join(timeout=30.0), server.snapshot()
    server.close()
    assert server.error is None, server.error
    assert compile_count() - c0 == len({l.level for l in logs})
    for k in p_run:
        assert torch.equal(server.params[k], p_run[k]), k


def test_sweep_halving_survivors_on_card(cuda_device):
    """T=24 of the Figure-1 setting with adagrad_norm, rungs at 8 and 16:
    CWTM lanes under sign_flip, ipm, random and alie at two deltas, Krum
    and NNM+CWTM lanes; every survivor bitwise equal to a sweep of the
    surviving subset, each cell pruned at the first rung bitwise equal to
    the full grid's sweep stopped there."""
    from repro_torch import SweepSpec, Task, adagrad_norm, build_session
    (params0, grad_fn, sampler, _), cfg = _fig1(cuda_device)
    task = Task(params0, grad_fn, lambda m: sampler, lambda p: 0.0)
    T = 24
    sess = build_session(cfg, task, m=FIG1["m"], opt=adagrad_norm(0.5))
    sws = tuple(("periodic", {"n_byz": FIG1["n_byz"], "K": k})
                for k in (10, 25, 10, 25, 10, 25))
    spec = SweepSpec(
        switchers=sws,
        attacks=("sign_flip", "ipm", ("random", {"scale": 10.0}), "alie",
                 "ipm", "sign_flip"),
        aggregators=(("cwtm", {"delta": FIG1["delta"]}), ("cwtm", {"delta": 0.35}),
                     ("cwtm", {"delta": 0.35}), ("cwtm", {"delta": FIG1["delta"]}),
                     ("krum", {"delta": FIG1["delta"]}),
                     ("nnm+cwtm", {"delta": 0.35})))

    def objective(p):
        return float(sum(v.double().square().sum() for v in p.values()))

    out = sess.sweep_halving(spec, T, objective=objective, keep=0.5,
                             rungs=[8, 16])
    alive = [c for c, o in enumerate(out) if not o["pruned"]]
    assert 0 < len(alive) < spec.lanes
    for j, (p, logs) in enumerate(sess.sweep(spec.lane_subset(alive), T)):
        [(ph, lh)] = out[alive[j]]["results"]
        assert [vars(l) for l in lh] == [vars(l) for l in logs]
        for k in p:
            assert torch.equal(ph[k], p[k]), (alive[j], k)
    stopped = sess.sweep(spec, 8)
    for c, o in enumerate(out):
        if o["rounds_run"] == 8:
            [(ph, lh)] = o["results"]
            assert [vars(l) for l in lh] == [vars(l) for l in stopped[c][1]]
            assert all(torch.equal(ph[k], stopped[c][0][k]) for k in ph), c


LANE_COUNTS = (8, 5, 3, 2, 1)
FIG1_LEAVES = {"b1": (128,), "b2": (10,), "w1": (64, 128), "w2": (128, 10)}


def _lane_leaves(dev, lead, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(lead + shape, generator=g).to(dev)
            for k, shape in FIG1_LEAVES.items()}


def _first_lanes(tree, C):
    return {k: v[:C].contiguous() for k, v in tree.items()}


@pytest.mark.parametrize("family", ["attacks", "unit_means", "optimizers",
                                    "aggregators"])
def test_lane_round_ops_ignore_the_lane_count(cuda_device, family):
    """What the sweep's lane round batches over the lanes, at the Figure-1
    leaves (m=17): each lane's bits are the same in batches of 8, 5, 3, 2
    and 1 lanes, so the halving's survivors equal a sweep of the surviving
    subset."""
    from torch.func import vmap
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.core import attacks as attacks_lib
    from repro_torch.core.robust_train import _lane_opt_step
    from repro_torch.core.agg_engine import agg_switch, agg_theta
    from repro_torch.core.mlmc import MLMCConfig
    from repro_torch.optim import optimizers
    m, n = FIG1["m"], 4
    masks = torch.rand(8, n, m, generator=torch.Generator().manual_seed(1)) < 0.4
    masks = masks.to(cuda_device)

    def check(run):
        full = run(8)
        for C in LANE_COUNTS[1:]:
            part = run(C)
            for k in part:
                assert torch.equal(part[k], full[k][:C]), (family, C, k)

    if family == "attacks":
        names = ("sign_flip", "ipm", "alie", "shift", "random", "none")
        ids = [0, 1, 1, 2, 3, 4, 2, 1]
        theta = torch.from_numpy(np.stack([
            attacks_lib.attack_theta(names[i]) for i in ids])).to(cuda_device)
        stack = _lane_leaves(cuda_device, (8, n, m))
        apply = attacks_lib.attack_switch(names)
        gen = torch.Generator(device=cuda_device)

        def run(C):
            gen.manual_seed(5)
            return apply(ids[:C], _first_lanes(stack, C), masks[:C], gen,
                         theta[:C])
        check(run)
    elif family == "unit_means":
        for units in (1, 2, 4, 32):
            grads = _lane_leaves(cuda_device, (8, m, units), seed=units)
            check(lambda C: {k: v.mean(2) for k, v in
                             _first_lanes(grads, C).items()})
            check(lambda C: {k: v[:, :, : max(units // 2, 1)].mean(2)
                             for k, v in _first_lanes(grads, C).items()})
    elif family == "optimizers":  # the lane round's step, a lane at a time
        params = _lane_leaves(cuda_device, (8,), seed=2)
        grads = _lane_leaves(cuda_device, (8,), seed=3)
        for opt in (optimizers.sgd(0.1), optimizers.adagrad_norm(0.5),
                    optimizers.adam(0.05), optimizers.momentum(0.1)):
            state = vmap(opt.init)(params)

            def run(C):
                p, s = _lane_opt_step(
                    opt, _first_lanes(params, C),
                    tree_map(lambda l: l[:C].contiguous(), state),
                    [{k: v[c] for k, v in grads.items()} for c in range(C)])
                return {**p, **{f"state/{i}": l for i, l in
                                enumerate(tree_leaves(s))}}
            check(run)
    else:
        mlmc = MLMCConfig(T=150, m=m, V=5.0, kappa=1.0, j_cap=5)
        names = ("cwtm", "cwmed", "mean", "krum", "nnm+cwtm", "geomed", "mfm")
        ids = [0, 0, 1, 2, 3, 4, 5, 6]
        theta = torch.from_numpy(np.stack([
            agg_theta(names[i], {"delta": FIG1["delta"]} if names[i] in
                      ("cwtm", "krum", "nnm+cwtm") else {}) for i in ids]))
        theta = theta.to(cuda_device)
        apply = agg_switch(names, backend="auto", mlmc=mlmc)
        stack = _lane_leaves(cuda_device, (8, m), seed=4)
        for nn in (1, 4):
            check(lambda C: apply(ids[:C], _first_lanes(stack, C), nn, theta[:C]))


# ------------------------------------------------- the model zoo on the card


def test_zoo_streamed_graphs_on_card(cuda_device):
    """The zoo's streamed driver (``run_dynabro_scan(microbatch=True)``) on
    the card at a small width (smollm-360m reduced to 64 wide, 2 layers,
    seq 16; m=17, 8 Byzantine, T=8): one ``cw_reduce`` launch an
    aggregation, a rerun bitwise (params and correction norms) with no
    capture, the plain backend's logs and params within 1e-5 of each leaf's
    largest |value|, and the CPU run's logs and params within 1e-4 of it
    (the card and the CPU sum the products in other orders)."""
    from repro_torch import (DynaBROConfig, MLMCConfig, get_switcher,
                             make_dynabro_scan_fn, run_dynabro_scan, sgd)
    from repro_torch.models import make_zoo_task
    T = 8

    def cfg(backend="auto"):
        return DynaBROConfig(
            mlmc=MLMCConfig(T=T, m=FIG1["m"], V=5.0, kappa=1.0, j_cap=2),
            aggregator="cwtm", delta=FIG1["delta"], attack="sign_flip",
            agg_backend=backend)

    def run(dev, c, scan_fn=None):
        task, _ = make_zoo_task("smollm-360m", seq_len=16, d_model=64,
                                device=dev)
        sw = get_switcher("periodic", FIG1["m"], n_byz=FIG1["n_byz"], K=4)
        return run_dynabro_scan(task.grad_fn, task.params0, sgd(0.05), c, sw,
                                task.make_sampler(FIG1["m"]), T, seed=1,
                                scan_fn=scan_fn, microbatch=True)

    task, _ = make_zoo_task("smollm-360m", seq_len=16, d_model=64,
                            device=cuda_device)
    scan_fn = make_dynabro_scan_fn(task.grad_fn, cfg(), sgd(0.05),
                                   microbatch=True)
    (p1, l1, _), n1 = _launch_counts(lambda: run(cuda_device, cfg(), scan_fn))
    dn1, captures = scan_fn.corr_norms.copy(), scan_fn.captures
    (p2, l2, _), n2 = _launch_counts(lambda: run(cuda_device, cfg(), scan_fn))
    levels = [l.level for l in l1]
    j_max = cfg().mlmc.j_max
    assert n1 == n2 == {"cw_reduce": sum(3 if 1 <= j <= j_max else 1
                                         for j in levels)}
    assert scan_fn.captures == captures == len(set(levels))
    assert [vars(l) for l in l1] == [vars(l) for l in l2]
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert np.array_equal(scan_fn.corr_norms, dn1)
    for other, lim in ((run(cuda_device, cfg("ref")), 1e-5),
                       (run("cpu", cfg()), 1e-4)):
        assert [vars(l) for l in other[1]] == [vars(l) for l in l1]
        for k in p1:
            want = other[0][k].to(cuda_device)
            scale = float(want.abs().max().clamp_min(1e-30))
            assert float((p1[k] - want).abs().max()) <= lim * scale, (k, lim)


# ------------------------------------------------- the zoo's families on the card


@pytest.fixture
def ieee_f32(cuda_device):
    """Float32 products without TF32, as the compiled driver runs them."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda_device
    torch.backends.cuda.matmul.allow_tf32 = old


def test_flash_attention_vmap_grad_replays_bitwise(ieee_f32):
    """``flash_attention`` under ``vmap(grad)`` over 17 workers, windowed
    GQA with the keys padded over two chunks, captured in a CUDA graph:
    each replay is bit for bit the eager call, and two replays agree."""
    from repro_torch.models.flash import flash_attention
    dev = ieee_f32
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(17, 1, 150, 4, 16, generator=gen, device=dev)
    k = torch.randn(17, 1, 150, 2, 16, generator=gen, device=dev)
    v = torch.randn(17, 1, 150, 2, 16, generator=gen, device=dev)
    w = torch.randn(1, 150, 4, 16, generator=gen, device=dev)

    def loss(q, k, v):
        return torch.sum(flash_attention(q, k, v, True, 40, 0, 96) * w)

    fn = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))
    eager = fn(q, k, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(q, k, v)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([o.clone() for o in out])
    for a, b, c in zip(eager, *replays):
        assert torch.equal(a, b) and torch.equal(b, c)
        assert bool(torch.isfinite(a).all())


def test_moe_ffn_and_causal_conv_bitwise_on_rerun(ieee_f32):
    """``moe_ffn`` (with drops and token groups) and Mamba's causal
    convolution, forward and gradient, twice on the card: the same bits."""
    from repro_torch.models import moe, ssm
    dev = ieee_f32
    gen = torch.Generator(device=dev).manual_seed(1)
    D, Fd, E = 64, 128, 4
    p = {"router": torch.randn(D, E, generator=gen, device=dev),
         "we1": torch.randn(E, D, Fd, generator=gen, device=dev) / 8,
         "we2": torch.randn(E, Fd, D, generator=gen, device=dev) / 11,
         "we3": torch.randn(E, D, Fd, generator=gen, device=dev) / 8}
    x = torch.randn(2, 128, D, generator=gen, device=dev)

    def moe_loss(p, x):
        out, aux = moe.moe_ffn(x, p, top_k=2, capacity_factor=0.5,
                               token_group=64)
        return out.square().sum() + aux

    cx = torch.randn(2, 128, 256, generator=gen, device=dev)
    cw = torch.randn(4, 256, generator=gen, device=dev)
    cb = torch.randn(256, generator=gen, device=dev)

    def conv_loss(x, w, b):
        return ssm._causal_conv(x, w, b).square().sum()

    for fn, args in ((moe_loss, (p, x)), (conv_loss, (cx, cw, cb))):
        grad = torch.func.grad(fn, argnums=tuple(range(len(args))))
        a, b = grad(*args), grad(*args)
        for ga, gb in zip(torch.utils._pytree.tree_leaves(a),
                          torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(ga, gb)
        assert torch.equal(fn(*args), fn(*args))


def test_whisper_full_width_unit_against_cpu(ieee_f32):
    """whisper-base at its published width and depth (113,959,936
    parameters, 1500 encoder frames): one unit's loss and gradient on the
    card against the plain CPU path, at ``tests/test_torch_models.py``'s
    MODEL_TOL (rtol 1e-4, atol 1e-6 times the larger of 1 and the leaf's
    largest |value|)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import loss_fn
    dev = ieee_f32
    cfg = get_config("whisper-base")
    params = init_params(cfg, 0, device="cpu")
    assert sum(v.numel() for v in params.values()) == 113_959_936
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
             "extra": {"frames": torch.randn(1, 1500, 512, generator=gen)}}

    def value_and_grad(p, b):
        return torch.func.grad_and_value(lambda q: loss_fn(q, b, cfg))(p)

    g_cpu, l_cpu = value_and_grad(params, batch)
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(dev), batch)
    g_dev, l_dev = value_and_grad({k: v.to(dev) for k, v in params.items()},
                                  on_card)
    torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=1e-4, atol=1e-6)
    for k in g_cpu:
        scale = max(1.0, float(g_cpu[k].abs().max()))
        torch.testing.assert_close(g_dev[k].cpu(), g_cpu[k], rtol=1e-4,
                                   atol=1e-6 * scale, msg=k)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-0.6b",
                                  "qwen2-moe-a2.7b", "arctic-480b",
                                  "whisper-base", "llama-3.2-vision-90b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_decode_on_card_against_cpu(ieee_f32, arch):
    """``prefill`` and three greedy ``decode_step`` calls of the reduced
    arch (d_model 64) on the card against the plain CPU path: logits at
    MODEL_TOL (rtol 1e-4, atol 1e-6 times the larger of 1 and the largest
    |logit|; 3e-6 for rwkv6 and jamba) and the same tokens; each card step
    with the device ``pos`` under ``set_sync_debug_mode("error")``."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import decode_step, init_params, prefill
    dev = ieee_f32
    cfg = get_reduced_config(arch, d_model=64)
    params = init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 7), generator=gen)
    extra = None
    if cfg.family in ("audio", "vlm"):
        name, n = (("frames", cfg.encoder_seq) if cfg.family == "audio"
                   else ("patches", cfg.n_image_tokens))
        extra = {name: torch.randn(2, n, 64, generator=gen)}
    atol = 3e-6 if cfg.family in ("ssm", "hybrid") else 1e-6

    def greedy(p, toks, extra, device, sync_check):
        logits, cache = prefill(p, toks, cfg, extra=extra, pad_to=11)
        pos = torch.tensor(7, device=device)
        out = [logits]
        for _ in range(3):
            if sync_check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = decode_step(p, cache, out[-1].argmax(-1), pos,
                                            cfg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out.append(logits)
            pos = pos + 1
        return torch.stack(out, 1)

    want = greedy(params, toks, extra, "cpu", False)
    got = greedy({k: v.to(dev) for k, v in params.items()}, toks.to(dev),
                 None if extra is None else
                 {k: v.to(dev) for k, v in extra.items()}, dev, True).cpu()
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=atol * max(1.0, float(want.abs().max())))


# ------------------------------------------------- the recomputing forward


def _replays_equal_eager(fn, *args):
    """``fn(*args)`` eagerly, then captured in a CUDA graph (warmed up on a
    side stream) and replayed twice: returns (eager, replays) as leaf
    lists."""
    leaves = torch.utils._pytree.tree_leaves
    eager = leaves(fn(*args))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = leaves(fn(*args))
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([o.clone() for o in out])
    return eager, replays


def test_chunk_recompute_bitwise_and_captured_on_card(ieee_f32):
    """``selective_scan`` (each chunk a recomputing ``_Chunk``) under
    ``vmap(grad)`` over 17 workers, 40 steps in chunks of 16 (the last one
    short), with a start state: every input's gradient bitwise the
    un-recomputed scan's on the card, and a captured CUDA graph of it
    replays those bits."""
    from repro_torch.models import ssm
    dev = ieee_f32
    gen = torch.Generator(device=dev).manual_seed(4)
    m, Bt, L, di, ds = 17, 2, 40, 64, 8
    x = torch.randn(m, Bt, L, di, generator=gen, device=dev)
    delta = torch.nn.functional.softplus(
        torch.randn(m, Bt, L, di, generator=gen, device=dev))
    A = -torch.exp(torch.randn(di, ds, generator=gen, device=dev) / 2)
    B = torch.randn(m, Bt, L, ds, generator=gen, device=dev)
    C = torch.randn(m, Bt, L, ds, generator=gen, device=dev)
    D = torch.randn(di, generator=gen, device=dev)
    h0 = torch.randn(m, Bt, di, ds, generator=gen, device=dev)
    w = torch.randn(Bt, L, di, generator=gen, device=dev)

    def grads(body):
        def loss(x, delta, A, B, C, D, h0):
            y, h = ssm._scan_chunks(body, x, delta, A, B, C, D, h0, 16)
            return torch.sum(y * w) + h.square().sum()
        return torch.func.vmap(torch.func.grad(loss, argnums=tuple(range(7))),
                               in_dims=(0, 0, None, 0, 0, None, 0))

    args = (x, delta, A, B, C, D, h0)
    want = grads(ssm._chunk_body)(*args)
    eager, replays = _replays_equal_eager(grads(ssm._Chunk.apply), *args)
    for a, b, c, d in zip(want, eager, *replays):
        assert torch.equal(a, b) and torch.equal(b, c) and torch.equal(c, d)
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-base",
                                  "qwen2-moe-a2.7b"])
def test_group_recompute_bitwise_and_captured_on_card(ieee_f32, arch):
    """One unit's ``vmap(grad(loss_fn))`` over 17 workers of the reduced
    arch (d_model 64; jamba nests the chunk recompute, whisper's decoder
    reads the encoder's output, qwen2-moe routes with capacity and adds
    the router aux): ``forward(remat=True)``'s gradients bitwise
    ``remat=False``'s on the card, and a captured CUDA graph of the
    recomputing path replays those bits."""
    import functools
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.models import transformer as tf
    dev = ieee_f32
    cfg = get_reduced_config(arch, d_model=64)
    params = init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (17, 2, 16), generator=gen,
                         device=dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 2)}
    if cfg.family in ("audio", "vlm"):
        name, n = (("frames", cfg.encoder_seq) if cfg.family == "audio"
                   else ("patches", cfg.n_image_tokens))
        batch["extra"] = {name: torch.randn(17, 2, n, 64, generator=gen,
                                            device=dev)}

    def worker_grads(remat):
        def loss(p, b):
            orig = tf.forward
            tf.forward = functools.partial(orig, remat=remat)
            try:
                return tf.loss_fn(p, b, cfg)
            finally:
                tf.forward = orig
        return torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))

    want = worker_grads(False)(params, batch)
    eager, replays = _replays_equal_eager(worker_grads(True), params, batch)
    leaves = torch.utils._pytree.tree_leaves(want)
    assert len(leaves) == len(eager)
    for a, b, c, d in zip(leaves, eager, *replays):
        assert torch.equal(a, b) and torch.equal(b, c) and torch.equal(c, d)
        assert bool(torch.isfinite(a).all())


class _RankOf:
    """A (workers, 'model') mesh as one rank of it sees it, without process
    groups: enough for ``ShardPlan``'s blocks and sums."""

    axis_names = ("workers", "model")

    def __init__(self, shape, w, c):
        self.shape = dict(zip(self.axis_names, shape))
        self._coord = {"workers": w, "model": c}

    def coordinate(self, axis):
        return self._coord[axis]


def test_sharded_aggregation_on_card(cuda_device):
    """The GSPMD path's aggregation on a (2, 2) mesh, every rank's blocks
    in one process: K1 on a rank's block tree bitwise the unsharded tree
    reduce's columns and within TOL of the plain version's; K3's and K6's
    per-leaf partials of the four ranks summed in rank order
    (``ShardPlan.add_partials``) against the unsharded kernels and against
    the plain versions' partials summed the same way."""
    from repro_torch.core.sharded import ShardPlan

    m, shape = 17, (2, 2)
    specs = {"a": ("workers", "model"), "b": ("workers",), "c": (None, "model"),
             "d": (None,)}
    gen = torch.Generator().manual_seed(7)
    stack = {"a": torch.randn(m, 64, 96, generator=gen),
             "b": torch.randn(m, 130, generator=gen),
             "c": torch.randn(m, 8, 40, generator=gen),
             "d": torch.randn(m, 33, generator=gen)}
    z = {k: torch.randn(v.shape[1:], generator=gen) for k, v in stack.items()}
    stack = {k: v.to(cuda_device) for k, v in stack.items()}
    z = {k: v.to(cuda_device) for k, v in z.items()}
    full = agg_engine.tree_cw_reduce(stack, "tm", 8, backend="kernel")
    plans = [ShardPlan(_RankOf(shape, w, c), "workers", specs)
             for w in range(2) for c in range(2)]
    parts = {"pair": [], "cross": [], "pair_ref": [], "cross_ref": []}
    for plan in plans:
        blocks = {k: plan.block(k, v, 1).contiguous() for k, v in stack.items()}
        zb = {k: plan.block(k, v, 0) for k, v in z.items()}
        before = fused.LAUNCHES["cw_reduce"]
        got = agg_engine.tree_cw_reduce(blocks, "tm", 8, backend="kernel")
        assert fused.LAUNCHES["cw_reduce"] == before + 1  # a tree, one launch
        want = {k: plan.block(k, v, 0) for k, v in full.items()}
        plain = agg_engine.tree_cw_reduce(blocks, "tm", 8, backend="ref")
        for k in stack:
            assert torch.equal(got[k], want[k]), k
            torch.testing.assert_close(got[k], plain[k], **TOL)
        for name, backend in (("", "kernel"), ("_ref", "ref")):
            parts["pair" + name].append({k: agg_engine.pairwise_sqdist(
                agg_engine._as_mat(blocks[k]), backend=backend)
                for k in sorted(blocks)})
            parts["cross" + name].append({k: agg_engine.cross_sqdist(
                agg_engine._as_mat(blocks[k]),
                zb[k].reshape(1, -1).contiguous(), backend=backend)[:, 0]
                for k in sorted(blocks)})

    def summed(per_rank):
        keys = sorted(per_rank[0])
        table = torch.stack([torch.cat([p[k].reshape(-1) for k in keys])
                             for p in per_rank]).reshape(2, 2, -1)
        return plans[0].add_partials(table, {k: tuple(per_rank[0][k].shape)
                                             for k in keys})

    rows = [agg_engine._as_mat(v) for v in stack.values()]
    d2 = agg_engine.tree_pairwise_sqdist(stack, backend="kernel")
    dz = agg_engine.tree_cross_sqdist(stack, z, backend="kernel")
    _dist_close(summed(parts["pair"]), d2, *rows)
    _dist_close(summed(parts["pair"]), summed(parts["pair_ref"]), *rows)
    _dist_close(summed(parts["cross"]), dz, *rows)
    _dist_close(summed(parts["cross"]), summed(parts["cross_ref"]), *rows)
    # every rank's sum from the same table: the same bits
    assert all(torch.equal(plans[0].add_partials(
        torch.zeros(2, 2, 4, device=cuda_device), {"d": (4,)}),
        p.add_partials(torch.zeros(2, 2, 4, device=cuda_device), {"d": (4,)}))
        for p in plans)
