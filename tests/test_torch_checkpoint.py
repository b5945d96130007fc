"""The port's carry checkpoints: the JAX package's key paths and
``.npz``/``.json`` layout, so a carry saved by either package loads in the
other with its values and dtypes; and a run resumed from a checkpoint of
its carry is bitwise the uninterrupted run (``random`` included, whose
generator state the carry holds)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tasks import torch_softmax
from repro.checkpoint import checkpoint as j_ckpt
from repro_torch.api import session as t_session
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.core import mlmc as t_mlmc
from repro_torch.core import robust_train as t_rt
from repro_torch.core import switching as t_switching
from repro_torch.optim import optimizers as t_optim

M, T, SEED = 7, 12, 5


def _carries():
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(6, 3)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    adam = {"m": {k: v * 0.5 for k, v in p.items()},
            "v": {k: v * v for k, v in p.items()}, "t": np.int32(7)}
    return [(p, np.float32(2.5)), (p, adam), (p, ()),
            ({"x": np.array([1.5, -2.25], np.float32),
              "c": np.array([3], np.int32)}, np.float32(7.125))]


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, conv) for v in tree)
    return conv(np.asarray(tree))


def _flat(tree):
    return dict(t_ckpt._leaves(tree))


@pytest.mark.parametrize("i", range(4))
def test_jax_carry_loads_in_the_port_and_back(tmp_path, i):
    carry = _carries()[i]
    jc = _to(carry, jnp.asarray)
    tc = _to(carry, torch.from_numpy)
    j_ckpt.save_checkpoint(str(tmp_path / "j"), jc, step=4)
    got = t_ckpt.load_checkpoint(str(tmp_path / "j"), tc)
    assert t_ckpt.checkpoint_step(str(tmp_path / "j")) == 4
    for (k, a), (k2, b) in zip(_flat(got).items(), _flat(tc).items()):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    t_ckpt.save_checkpoint(str(tmp_path / "t.npz"), got, step=9)
    back = j_ckpt.load_checkpoint(str(tmp_path / "t.npz"), jc)
    assert j_ckpt.checkpoint_step(str(tmp_path / "t")) == 9
    import jax
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(str(tmp_path / "t.npz")) as t_npz, \
            np.load(str(tmp_path / "j.npz")) as j_npz:
        assert sorted(t_npz.files) == sorted(j_npz.files)


def test_bfloat16_and_shape_checks(tmp_path):
    carry = ({"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)
              .to(torch.bfloat16)}, torch.tensor(1.0))
    path = str(tmp_path / "bf")
    t_ckpt.save_checkpoint(path, carry)
    with np.load(path + ".npz") as f:
        assert f["0/w"].dtype == np.float32
    got = t_ckpt.load_checkpoint(path, carry)
    assert got[0]["w"].dtype == torch.bfloat16
    assert torch.equal(got[0]["w"], carry[0]["w"])
    with pytest.raises(AssertionError):
        t_ckpt.load_checkpoint(path, ({"w": torch.zeros(3, 2)}, torch.tensor(0.0)))


def test_latest_checkpoint(tmp_path):
    d = str(tmp_path)
    assert t_ckpt.latest_checkpoint(os.path.join(d, "missing")) is None
    for step in (3, 11, 7):
        t_ckpt.save_checkpoint(os.path.join(d, f"run_{step}"), {"a": torch.ones(2)},
                               step=step)
    t_ckpt.save_checkpoint(os.path.join(d, "other_99"), {"a": torch.ones(2)}, step=99)
    os.remove(os.path.join(d, "other_99.npz"))  # a lone half is skipped
    t_ckpt.save_checkpoint(os.path.join(d, "run_50"), {"a": torch.ones(2)}, step=50)
    os.remove(os.path.join(d, "run_50.json"))
    assert t_ckpt.latest_checkpoint(d) == (os.path.join(d, "run_11"), 11)
    assert t_ckpt.latest_checkpoint(d, prefix="other") is None
    assert t_ckpt.latest_checkpoint(d) == j_ckpt.latest_checkpoint(d)


@pytest.mark.parametrize("attack", ["sign_flip", "random"])
def test_resume_from_checkpoint_is_bitwise(tmp_path, attack):
    """Step half a run, save the carry, load it into a new session's carry
    and step the rest: the params of an uninterrupted ``run``. adagrad_norm
    carries state, and ``random`` its generator's."""
    task = torch_softmax()
    cfg = t_rt.DynaBROConfig(
        mlmc=t_mlmc.MLMCConfig(T=T, m=M, V=2.0, j_cap=3), aggregator="cwmed",
        attack=attack)

    def session():
        return t_session.build_session(
            cfg, task, switcher=t_switching.get_switcher(
                "periodic", M, n_byz=3, K=5, seed=SEED),
            opt=t_optim.adagrad_norm(0.5), seed=SEED)

    sess = session()
    p_full, _, _ = sess.run(T)
    sched = sess.schedule(T)
    carry = sess.init_carry()
    for t in range(T // 2):
        carry, _ = sess.step(carry, sess.round_inputs(sched, t))
    path = str(tmp_path / "mid")
    t_ckpt.save_checkpoint(path, carry, step=T // 2)
    fresh = session()
    restored = t_ckpt.load_checkpoint(path, fresh.init_carry())
    for (k, a), (_, b) in zip(_flat(restored).items(), _flat(carry).items()):
        assert torch.equal(a, b), k
    for t in range(t_ckpt.checkpoint_step(path), T):
        restored, _ = fresh.step(restored, fresh.round_inputs(fresh.schedule(T), t))
    for k in p_full:
        assert torch.equal(restored[0][k], p_full[k]), k
