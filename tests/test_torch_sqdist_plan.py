"""The block planner of the distance kernels (``kernels/fused.py::
sqdist_plan``), a pure function of the pair count and d that runs on the
CPU: every column belongs to one block, no block is empty, the grid stays
within one block per SM, and small d takes one block (no scratch, no step
across blocks). The kernels themselves are held to their plain versions on
the card, in tests/test_torch_cuda.py.
"""
import pytest
import torch

from repro_torch.kernels import fused

UNIT = fused.SQDIST_UNIT
PAIRS = [1, 2, 3, 17, 51, 153, 528, 2080, 4096]
DS = [1, 3, 10, 63, 64, 65, 128, 129, 960, 961, 1280, 8192, 9610, 1 << 20,
      1 << 24]


def _wanted_units(n_pairs):
    return max(1, min(fused.SQDIST_MAX_UNITS,
                      fused.SQDIST_PAIR_COLS // (n_pairs * UNIT)))


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n_pairs", PAIRS)
def test_plan_covers_d_with_no_empty_block(n_pairs, d):
    blocks, per_block = fused.sqdist_plan(n_pairs, d)
    n_units = -(-d // UNIT)
    assert 1 <= blocks <= fused.SQDIST_MAX_BLOCKS
    assert per_block >= 1
    assert blocks * per_block * UNIT >= d  # every column has its block
    assert (blocks - 1) * per_block < n_units  # the last block has work
    assert per_block == -(-n_units // blocks)  # spread evenly
    want = _wanted_units(n_pairs)
    if -(-n_units // want) <= fused.SQDIST_MAX_BLOCKS:
        assert per_block <= want  # no wider than the tuned share
    else:
        assert per_block >= want  # the cap widens the share, never narrows


@pytest.mark.parametrize("n_pairs", PAIRS)
def test_plan_is_one_block_up_to_its_share(n_pairs):
    width = _wanted_units(n_pairs) * UNIT
    assert fused.sqdist_plan(n_pairs, width) == (1, -(-width // UNIT))
    assert fused.sqdist_plan(n_pairs, 1).blocks == 1
    assert fused.sqdist_plan(n_pairs, width + 1).blocks == 2


@pytest.mark.parametrize("d,pairwise,cross", [
    (8192, (64, 2), (64, 2)),
    (1280, (10, 2), (10, 2)),
    (128, (1, 2), (1, 2)),
    (10, (1, 1), (1, 1)),
    (9610, (76, 2), (76, 2)),
])
def test_plan_at_main_path_shapes(d, pairwise, cross):
    """The plans the main path's leaves (17 workers) and the flat vector
    get: m(m+1)/2 = 153 Gram pairs, and 17 cross pairs at k = 1."""
    assert tuple(fused.sqdist_plan(17 * 18 // 2, d)) == pairwise
    assert tuple(fused.sqdist_plan(17, d)) == cross


@pytest.mark.parametrize("n_pairs,d", [(1, 5), (153, 9610), (4096, 1 << 20)])
def test_plan_is_pure(n_pairs, d):
    """The same plan from the cache and computed afresh."""
    cached = fused.sqdist_plan(n_pairs, d)
    fused.sqdist_plan.cache_clear()
    assert fused.sqdist_plan(n_pairs, d) == cached


@pytest.mark.parametrize("n_pairs,d", [(0, 10), (17, 0), (-1, 5)])
def test_plan_rejects_empty_work(n_pairs, d):
    with pytest.raises(ValueError):
        fused.sqdist_plan(n_pairs, d)


def test_cpu_calls_plan_nothing_and_allocate_no_counter():
    """On CPU tensors the wrappers take the plain versions and leave the
    card's counters alone."""
    before = (dict(fused._COUNTERS), dict(fused._SLOTS), dict(fused.LAUNCHES))
    x = torch.randn(17, 300)
    fused.pairwise_sqdist(x)
    fused.cross_sqdist(x, x[:1])
    assert (fused._COUNTERS, fused._SLOTS, fused.LAUNCHES) == before
