"""The port's sharding rules (``repro_torch.launch.sharding``,
``core/sharded.fsdp_axis_for``) held exactly to the JAX package's
``launch/sharding.py`` for every arch of ``repro.configs.ARCH_IDS`` at its
published size: ``plan_params`` (specs and plans, ``fsdp`` True and False),
``opt_specs`` (sgd, momentum, adam, adagrad_norm), ``batch_specs`` and
``cache_spec_tree``, on (1, 1), (2, 2), (4, 2) and (16, 16) meshes over
("data", "model") and a (2, 16, 16) mesh over ("pod", "data", "model").

Both packages read only a mesh's ``shape`` and ``axis_names``, so the
meshes are stand-ins. A JAX ``PartitionSpec`` is compared as the tuple of
its entries, a JAX tree as the port's flat "/"-joined keys. Exact equality
throughout: the rules are integer arithmetic on shapes.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as j_configs
from repro.core import sharded as j_sharded
from repro.launch import sharding as j_sharding
from repro.optim import optimizers as j_optim
from repro_torch import configs as t_configs
from repro_torch.core import sharded as t_sharded
from repro_torch.launch import sharding as t_sharding
from repro_torch.optim import optimizers as t_optim

ARCHS = tuple(j_configs.ARCH_IDS)


class StandIn:
    """A mesh as both packages' rules read it."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))

    def __repr__(self):
        return f"StandIn{tuple(self.shape.items())}"


MESHES = {
    "(1, 1)": StandIn((1, 1), ("data", "model")),
    "(2, 2)": StandIn((2, 2), ("data", "model")),
    "(4, 2)": StandIn((4, 2), ("data", "model")),
    "(16, 16)": StandIn((16, 16), ("data", "model")),
    "(2, 16, 16)": StandIn((2, 16, 16), ("pod", "data", "model")),
}


def _names(path):
    return "/".join(str(getattr(e, "key", getattr(e, "name", e)))
                    for e in path)


def _flat_specs(tree):
    """A JAX spec tree -> {"a/b": tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_names(p): tuple(s) for p, s in leaves}


def _flat(tree):
    return {_names(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        tree)[0]}


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return j_configs.get_config(arch), t_configs.get_config(arch)


def test_configs_agree():
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        assert jc.n_layers == tc.n_layers and jc.d_model == tc.d_model, arch


# ------------------------------------------------------------ the rules


@pytest.mark.parametrize("shape,model_size", [
    ((960, 960), 2), ((960, 320), 16), ((49152, 960), 16), ((7, 4096), 2),
    ((64, 64), 2), ((128, 128), 2), ((8, 960, 2560), 4), ((3, 960, 2560), 4),
    ((2048,), 2), ((), 2)])
def test_model_axis_rule_matches_jax(shape, model_size):
    names = ["wq", "wk", "wo", "w1", "w2", "we1", "we2", "we3", "embed",
             "unembed", "dec_pos", "conv_w", "A_log", "scale", "router"]
    paths = [("blocks", "b0", "mix", n) for n in names] + [
        ("blocks", "b1", "mlp", "wv"), ("blocks", "b0", "mix", "wv"), (), ("wv",)]
    for path in paths:
        want = j_sharding.model_axis_rule(path, shape, model_size)
        assert t_sharding.model_axis_rule(path, shape, model_size) == want, path


@pytest.mark.parametrize("shape", [(960, 960), (17, 4096), (49152, 960),
                                   (255, 257), (65536,), (100,), (3, 64, 512)])
def test_fsdp_axis_for_matches_jax(shape):
    for m in (1, 2, 4, 16, 32):
        for model_axis in (None, 0, 1):
            want = j_sharded.fsdp_axis_for(shape, m, model_axis)
            assert t_sharded.fsdp_axis_for(shape, m, model_axis) == want


# ------------------------------------------------------------ parameters


@functools.lru_cache(maxsize=None)
def _jax_plan(arch, mesh_name, fsdp):
    return j_sharding.plan_params(_cfgs(arch)[0], MESHES[mesh_name], fsdp=fsdp)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_params_matches_jax(arch, mesh_name, fsdp):
    specs_j, plans_j = _jax_plan(arch, mesh_name, fsdp)
    specs_t, plans_t = t_sharding.plan_params(_cfgs(arch)[1], MESHES[mesh_name],
                                              fsdp=fsdp)
    assert specs_t == _flat_specs(specs_j)
    assert plans_t == {"top": _flat(plans_j["top"]),
                       "blocks": _flat(plans_j["blocks"])}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax_and_allocate_nothing(arch):
    jc, tc = _cfgs(arch)
    want = _flat(j_sharding.abstract_params(jc, jnp.bfloat16))
    got = t_sharding.abstract_params(tc)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam", "adagrad_norm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_jax(arch, opt):
    jc, tc = _cfgs(arch)
    mesh = MESHES["(4, 2)"]
    specs_j, _ = _jax_plan(arch, "(4, 2)", True)
    state_j = jax.eval_shape(j_optim.get_optimizer(opt, 0.1).init,
                             j_sharding.abstract_params(jc, jnp.bfloat16))
    want = j_sharding.opt_specs(state_j, specs_j)
    specs_t, _ = t_sharding.plan_params(tc, mesh, fsdp=True)
    state_t = t_optim.get_optimizer(opt, 0.1).init(t_sharding.abstract_params(tc))
    got = t_sharding.opt_specs(state_t, specs_t)
    if opt == "adam":
        assert got == {"m": _flat_specs(want["m"]),
                       "v": _flat_specs(want["v"]), "t": tuple(want["t"])}
    elif opt == "momentum":
        assert got == _flat_specs(want)
    else:
        assert got == tuple(want)  # sgd: (); adagrad-norm's scalar: P()


# ------------------------------------------------------------ batch, cache


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_jax(arch, mesh_name):
    jc, tc = _cfgs(arch)
    for batch in (3, 8, 64):
        for kind in ("train", "prefill", "decode"):
            want = j_sharding.batch_specs(jc, MESHES[mesh_name], batch, kind)
            got = t_sharding.batch_specs(tc, MESHES[mesh_name], batch, kind)
            assert got == {
                k: ({n: tuple(e) for n, e in v.items()}
                    if isinstance(v, dict) else tuple(v))
                for k, v in want.items()}, (batch, kind)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_tree_matches_jax(arch, mesh_name):
    jc, tc = _cfgs(arch)
    for batch, seq in ((8, 64), (3, 4096)):
        shapes_j, specs_j = j_sharding.cache_spec_tree(jc, MESHES[mesh_name],
                                                       batch, seq)
        shapes_t, specs_t = t_sharding.cache_spec_tree(tc, MESHES[mesh_name],
                                                       batch, seq)
        assert specs_t == _flat_specs(specs_j)
        assert {k: tuple(v.shape) for k, v in shapes_t.items()} == {
            k: tuple(v.shape) for k, v in _flat(shapes_j).items()}
        assert all(v.device.type == "meta" for v in shapes_t.values())


def test_cache_specs_need_a_data_axis_as_in_jax():
    jc, tc = _cfgs("smollm-360m")
    mesh = StandIn((2, 2), ("workers", "model"))
    with pytest.raises(KeyError):
        j_sharding.cache_specs(jc, mesh, 8)
    with pytest.raises(KeyError):
        t_sharding.cache_specs(tc, mesh, 8)


def test_strip_model_matches_jax():
    specs_j, _ = _jax_plan("qwen2-moe-a2.7b", "(4, 2)", True)
    specs_t, _ = t_sharding.plan_params(_cfgs("qwen2-moe-a2.7b")[1],
                                        MESHES["(4, 2)"], fsdp=True)
    assert t_sharding.strip_model(specs_t) == _flat_specs(
        j_sharding.strip_model(specs_j))
    assert any("model" in s for s in specs_t.values())
    assert not any("model" in s for s in t_sharding.strip_model(specs_t).values())


def test_abstract_params_of_the_largest_arch_take_no_memory():
    """arctic-480b's and jamba-1.5-large-398b's trees, hundreds of billions
    of parameters, as meta tensors."""
    for arch in ("arctic-480b", "jamba-1.5-large-398b"):
        params = t_sharding.abstract_params(_cfgs(arch)[1])
        assert sum(v.numel() for v in params.values()) > 3e11
        assert all(v.device == torch.device("meta") for v in params.values())
