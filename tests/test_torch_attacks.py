"""The port's attacks (``repro_torch/core/attacks.py``) against the JAX
package's, on the same numpy inputs.

Tolerances:

  * deterministic attacks on float32 stacks: atol 1e-6 (honest means and
    variances summed in another order, a few float32 ulps of values of
    order 1);
  * on bfloat16 stacks: one bfloat16 ulp (rtol 2^-7) over atol 1e-6, since a
    float32 result a few ulps apart can round to the neighbouring bfloat16;
  * ``alie_auto_z``: rtol 1e-6 (``ndtri`` of float32 in two libraries);
  * the App. E schedule helpers are plain Python: equal.

``random`` draws from a ``torch.Generator``, not JAX's threefry stream, so
it is held to its statistics, to honest rows left untouched bit for bit, to
the same bits from the same seed, and to the draw order the drivers rely on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as j_attacks
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro_torch.core import attacks as t_attacks
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt

F32_TOL = dict(rtol=0, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
DETERMINISTIC = [
    ("none", {}), ("sign_flip", {}), ("sign_flip", {"scale": 2.5}),
    ("ipm", {}), ("ipm", {"eps": 0.5}), ("alie", {}), ("alie", {"z": None}),
    ("shift", {}), ("shift", {"v": -3.0}),
]
SHAPES = {"a": (), "b": (5,), "c": (3, 4), "d": (2, 3, 2)}  # leaves of 1-3 dims


def _id(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


def _stack(m, seed, lead=()):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=lead + (m,) + s) * 2.0).astype(np.float32)
            for k, s in SHAPES.items()}


def _mask(m, kind, seed):
    if kind == "none":
        return np.zeros(m, bool)
    if kind == "all":
        return np.ones(m, bool)
    mask = np.random.default_rng(seed).random(m) < 0.4
    mask[0], mask[-1] = True, False  # some, whatever the draw
    return mask


def _compare(got, want, dtype):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == dtype, k
        np.testing.assert_allclose(
            got[k].to(torch.float32).numpy(),
            np.asarray(jnp.asarray(want[k], jnp.float32)), err_msg=k,
            **(F32_TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("case", DETERMINISTIC, ids=_id)
@pytest.mark.parametrize("m", [3, 17])
@pytest.mark.parametrize("kind", ["none", "some", "all"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deterministic_attack_matches_jax(case, m, kind, dtype):
    name, kw = case
    grads, mask = _stack(m, m), _mask(m, kind, m)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_attacks.get_attack(name, **kw)(
        {k: jnp.asarray(v, jdt) for k, v in grads.items()}, jnp.asarray(mask))
    got = t_attacks.get_attack(name, **kw)(
        {k: torch.from_numpy(v).to(tdt) for k, v in grads.items()},
        torch.from_numpy(mask))
    _compare(got, want, tdt)
    if kind == "none":  # no Byzantine worker: the stack comes back as it was
        for k in grads:
            assert torch.equal(got[k], torch.from_numpy(grads[k]).to(tdt))


@pytest.mark.parametrize("case", DETERMINISTIC, ids=_id)
def test_attack_stack_matches_jax(case):
    """The per-round driver's (m, n, ...) stack with a Byzantine set per
    within-round computation k, through ``_attack_stack``'s vmap."""
    name, kw = case
    m, n = 17, 4
    grads = {k: np.swapaxes(v, 0, 1) for k, v in _stack(m, 5, (n,)).items()}
    masks = np.stack([_mask(m, kind, 9 + i) for i, kind in
                      enumerate(["none", "some", "all", "some"])])
    mlmc_kw = dict(T=16, m=m, V=1.0)
    jcfg = j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**mlmc_kw), attack=name,
                              attack_kwargs=kw or None)
    tcfg = t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(**mlmc_kw), attack=name,
                              attack_kwargs=kw or None)
    want = j_rt._attack_stack(jcfg, {k: jnp.asarray(v) for k, v in grads.items()},
                              jnp.asarray(masks), jax.random.PRNGKey(0))
    got = t_rt._attack_stack(tcfg, {k: torch.from_numpy(v) for k, v in grads.items()},
                             torch.from_numpy(masks))
    _compare(got, want, torch.float32)


@pytest.mark.parametrize("m", [1, 2, 3, 16, 17, 64])
def test_alie_auto_z_every_byzantine_count(m):
    for b in range(m + 1):
        mask = np.zeros(m, bool)
        mask[:b] = True
        want = float(j_attacks.alie_auto_z(jnp.asarray(mask)))
        got = t_attacks.alie_auto_z(torch.from_numpy(mask))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=f"m={m} b={b}")


def test_momentum_attack_schedule_equal():
    for alpha in (0.01, 0.05, 0.1, 0.2, 1 / 3, 0.5, 1.0):
        for lam in (0.0, 1.0, 2.5):
            for t in range(0, 400, 3):
                assert (t_attacks.momentum_attack_v(t, alpha, lam)
                        == j_attacks.momentum_attack_v(t, alpha, lam)), (t, alpha, lam)
        for t in range(400):
            assert (t_attacks.momentum_attack_byz_index(t, alpha)
                    == j_attacks.momentum_attack_byz_index(t, alpha)), (t, alpha)


def test_get_attack_names():
    assert sorted(t_attacks.ATTACKS) == sorted(j_attacks.ATTACKS)
    assert set(t_attacks.STACK_ATTACKS) == {"random"}
    with pytest.raises(ValueError, match="unknown attack"):
        t_attacks.get_attack("nosuch")


# --------------------------------------------------------------- random


def _random_case(seed, scale=10.0, lead=()):
    m = 17
    rng = np.random.default_rng(seed)
    grads = {"w": rng.normal(size=lead + (m, 64, 32)).astype(np.float32),
             "b": rng.normal(size=lead + (m, 100)).astype(np.float32)}
    mask = rng.random(lead + (m,)) < 0.45
    mask[..., 0] = True
    mask[..., 1] = False
    gen = torch.Generator().manual_seed(seed)
    got = t_attacks.get_attack("random", scale=scale)(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        torch.from_numpy(mask), generator=gen)
    return grads, mask, got


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one_computation", "stack"])
@pytest.mark.parametrize("scale", [10.0, 0.5])
def test_random_statistics_and_honest_rows(lead, scale):
    grads, mask, got = _random_case(3, scale, lead)
    for k, v in grads.items():
        out = got[k].numpy()
        assert out.dtype == np.float32 and out.shape == v.shape
        np.testing.assert_array_equal(out[~mask], v[~mask])  # honest: untouched
        byz = out[mask].astype(np.float64).ravel()
        assert abs(byz.mean()) <= 5 * scale / np.sqrt(byz.size), k
        assert abs(byz.std() / scale - 1.0) <= 0.02, k


def test_random_same_bits_from_same_seed():
    _, _, a = _random_case(4)
    _, _, b = _random_case(4)
    _, _, c = _random_case(5)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    with pytest.raises(ValueError, match="generator"):
        t_attacks.random_noise({"w": torch.zeros(3, 2)}, torch.ones(3, dtype=torch.bool))


def test_random_stack_draw_order():
    """``_attack_stack`` draws each leaf's whole (n, m, ...) stack at once,
    leaves in sorted key order: the rule the two drivers share."""
    m, n, scale = 5, 4, 3.0
    rng = np.random.default_rng(6)
    grads = {"z": rng.normal(size=(m, n, 3)).astype(np.float32),
             "a": rng.normal(size=(m, n)).astype(np.float32)}
    masks = rng.random((n, m)) < 0.5
    cfg = t_rt.DynaBROConfig(mlmc=t_mlmc.MLMCConfig(T=16, m=m, V=1.0),
                             attack="random", attack_kwargs={"scale": scale})
    got = t_rt._attack_stack(cfg, {k: torch.from_numpy(v) for k, v in grads.items()},
                             torch.from_numpy(masks),
                             torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(11)
    for k in sorted(grads):
        noise = scale * torch.randn((n, m) + grads[k].shape[2:], generator=gen)
        mk = torch.from_numpy(masks).reshape((n, m) + (1,) * (grads[k].ndim - 2))
        want = torch.where(mk, noise, torch.from_numpy(np.swapaxes(grads[k], 0, 1)))
        assert torch.equal(got[k], torch.swapaxes(want, 0, 1)), k
