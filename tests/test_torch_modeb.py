"""Mode B's pieces of the port in one process, on the CPU, against the JAX
package: ``core/sharded.py``'s attack, rule check and param hook,
``launch/sharding.py``'s sharding types, ``launch/steps.py``'s builders on
one-rank meshes and their example inputs, ``_perf_cfg``, and the joint
worker axis of ``launch/mesh.py``. The multi-rank contracts are in
``tests/test_torch_modeb_ranks.py`` (8 gloo ranks against the JAX
package's 8-device run) and ``tests/test_torch_modeb_cli.py``.

- ``_attack_cotangent`` on an exchanged (m, ...) stack equals the JAX
  package's per-worker ``_attack_cotangent`` run under ``jax.vmap`` with
  the worker axis named (its ``psum``s over that axis), every attack, at
  rtol 1e-6, atol 1e-7 (sums in another order), the n_honest floor
  included.
- A rule that is not coordinate-wise raises the JAX package's
  ``ValueError``, in ``build_train_step`` itself.
- On a one-rank mesh the hook gives the loss and gradient of ``loss_fn``
  without it, bitwise (remat on and off, dense, MoE and audio), and a
  step is the plain SGD step on the rule's aggregate of one worker.
- The builders' example inputs equal the JAX package's case for case
  (``tests/test_steps_specs.py`` for the six families, and every param's
  shape, dtype and spec).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShape
from repro.core import sharded as j_sharded
from repro.core.mlmc import MLMCConfig as JMLMC
from repro.launch import sharding as j_sharding
from repro.launch import steps as j_steps
from repro_torch.configs import get_config, get_reduced_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import sharded
from repro_torch.core.mlmc import MLMCConfig
from repro_torch.launch import sharding as t_sharding
from repro_torch.launch import steps as t_steps
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.models import init_params, transformer
from repro_torch.optim.optimizers import sgd

FAMILY_ARCHS = ["smollm-360m", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
                "rwkv6-1.6b", "whisper-base", "llama-3.2-vision-90b"]
ATTACKS = ["none", "sign_flip", "ipm", "alie"]


def _byz(attack, m=4, **kw):
    return dict(axis_names=("data",), m=m, aggregator="cwtm",
                attack=attack, attack_param=0.7, **kw)


# ------------------------------------------------------------- the attack


@pytest.mark.parametrize("mask", [(1, 0, 1, 0), (1, 1, 1, 1), (0, 0, 0, 0)],
                         ids=["two", "all", "none"])
@pytest.mark.parametrize("attack", ATTACKS)
def test_attack_cotangent_matches_jax(attack, mask):
    rng = np.random.default_rng(3)
    stack = {"a": rng.standard_normal((4, 6, 5)).astype(np.float32),
             "b": rng.standard_normal((4, 7)).astype(np.float32)}
    maskf = np.asarray(mask, np.float32)
    jcfg = j_sharded.ShardedByzConfig(**_byz(attack))
    got = sharded._attack_cotangent({k: torch.from_numpy(v)
                                     for k, v in stack.items()},
                                    torch.from_numpy(maskf),
                                    sharded.ShardedByzConfig(**_byz(attack)))
    for k, v in stack.items():
        want = jax.vmap(lambda g, i: j_sharded._attack_cotangent(
            g, jnp.asarray(maskf), i, jcfg), axis_name="data")(
                jnp.asarray(v), jnp.arange(4))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_attack_keeps_the_dtype():
    stack = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    out = sharded._attack_cotangent(stack, torch.tensor([1.0, 0, 0, 0]),
                                    sharded.ShardedByzConfig(**_byz("alie")))
    assert out["w"].dtype == torch.bfloat16


# --------------------------------------------------------- rule and attack


@pytest.mark.parametrize("rule", ["krum", "geomed", "mfm", "nnm+cwtm"])
def test_rules_that_are_not_coordinate_wise_raise(rule):
    kw = dict(axis_names=("data",), m=4, aggregator=rule)
    with pytest.raises(ValueError) as want:
        j_sharded._make_leaf_agg(j_sharded.ShardedByzConfig(**kw))
    with pytest.raises(ValueError) as got:
        sharded._make_leaf_agg(sharded.ShardedByzConfig(**kw))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="coordinate-wise"):
        t_steps.build_train_step(reduced(get_config("smollm-360m")),
                                 make_test_mesh((1, 1)),
                                 ShapeConfig("t", 8, 4, "train"),
                                 aggregator=rule)
    with pytest.raises(ValueError, match="coordinate-wise"):
        sharded.ParamHook(sharded.ShardedByzConfig(**kw), {}, torch.zeros(4))


def test_build_errors():
    cfg, mesh = reduced(get_config("smollm-360m")), make_test_mesh((1, 1))
    with pytest.raises(ValueError, match="nosuch"):
        t_steps.build_train_step(cfg, mesh, ShapeConfig("t", 8, 4, "train"),
                                 attack="nosuch")
    with pytest.raises(ValueError, match="not divisible by m=4"):
        t_steps.build_train_step(cfg, Mesh(("data", "model"), (4, 1)),
                                 ShapeConfig("t", 8, 6, "train"))
    with pytest.raises(ValueError, match="unknown attack 'nosuch'"):
        sharded.ShardedByzConfig(("data",), 2, "cwtm", attack="nosuch")


# ----------------------------------------------------- one rank, the hook


def _one_rank_hook(cfg, aggregator="mean", attack="none", maskf=(0.0,)):
    mesh = make_test_mesh((1, 1))
    specs, _ = t_sharding.plan_params(cfg, mesh, fsdp=True,
                                      dtype=torch.float32)
    return sharded.ParamHook(
        sharded.ShardedByzConfig(("data",), 1, aggregator, attack=attack),
        sharded.scope_plans(mesh, specs), torch.tensor(maskf))


def _batch(cfg, rows=2, seq=8, seed=4):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, seq)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.family == "audio":
        batch["extra"] = {"frames": torch.randn(
            rows, cfg.encoder_seq, cfg.d_model,
            generator=torch.Generator().manual_seed(seed))}
    return batch


def _loss_and_grad(p, batch, cfg, **kw):
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    keys = sorted(leaves)
    loss = transformer.loss_fn(leaves, batch, cfg, **kw)
    return loss, dict(zip(keys, torch.autograd.grad(
        loss, [leaves[k] for k in keys])))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-moe-a2.7b",
                                  "whisper-base"])
def test_one_rank_hook_is_the_plain_gradient(arch, remat, monkeypatch):
    """On a (1, 1) mesh the hook gathers nothing and the mean of one worker
    is the worker: the loss and every leaf's gradient bitwise those without
    a hook; one hook call a scope, "top" once and "blocks" a group (twice
    with the recompute)."""
    cfg = get_reduced_config(arch, d_model=64)
    p = init_params(cfg, 2, dtype=torch.float32, device="cpu")
    batch = _batch(cfg)
    hook = _one_rank_hook(cfg)
    calls = []
    real = sharded.ParamHook.__call__
    monkeypatch.setattr(sharded.ParamHook, "__call__", lambda self, t, s: (
        calls.append(s), real(self, t, s))[1])
    monkeypatch.setattr(transformer, "forward", _with_remat(remat))
    want = _loss_and_grad(p, batch, cfg)
    got = _loss_and_grad(p, batch, cfg, param_hook=hook)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    assert calls == ["top"] + ["blocks"] * (cfg.n_groups * (2 if remat else 1))


def _with_remat(remat, _forward=transformer.forward):
    def forward(*a, **kw):
        kw["remat"] = remat
        return _forward(*a, **kw)
    return forward


def test_one_rank_steps_are_the_plain_steps():
    """``build_train_step`` on a (1, 1) mesh under sign_flip of the one
    worker: SGD on the negated gradient, bitwise; the MLMC step at J=1 with
    the fail-safe passing: ĝ⁰ + 2 (ĝ¹ − ĝ⁰) of the nested rows, bitwise."""
    cfg = reduced(get_config("qwen3-0.6b"))
    mesh, shape = make_test_mesh((1, 1)), ShapeConfig("t", 8, 2, "train")
    p = init_params(cfg, 3, dtype=torch.float32, device="cpu")
    step = t_steps.build_train_step(cfg, mesh, shape, aggregator="cwtm",
                                    attack="sign_flip", lr=0.1,
                                    dtype=torch.float32)
    batch = _batch(cfg, rows=2)
    blocks, state, loss = step.fn(step.place(p), (), batch, torch.ones(1))
    want_loss, g = _loss_and_grad(p, batch, cfg)
    assert state == () and torch.equal(loss, want_loss)
    assert all(torch.equal(blocks[k], p[k] - 0.1 * -g[k]) for k in p)
    mc = MLMCConfig(T=64, m=1, V=1e9)
    step = t_steps.build_mlmc_train_step(cfg, mesh, shape, mc, 1,
                                         aggregator="cwmed", lr=0.05,
                                         dtype=torch.float32)
    batch = _batch(cfg, rows=4)
    blocks, _, (ok, dn) = step.fn(step.place(p), (), batch, torch.zeros(1))
    g0 = _loss_and_grad(p, {k: v[:2] for k, v in batch.items()}, cfg)[1]
    g1 = _loss_and_grad(p, batch, cfg)[1]
    assert float(ok) == 1.0
    for k in p:
        want = p[k] - 0.05 * (g0[k] + 2.0 * (g1[k] - g0[k]))
        assert torch.equal(blocks[k], want), k


def test_one_rank_prefill_and_decode_are_the_plain_ones():
    cfg = reduced(get_config("smollm-360m"))
    mesh = make_test_mesh((1, 1))
    p = init_params(cfg, 1, dtype=torch.float32, device="cpu")
    toks = _batch(cfg, rows=2)["tokens"]
    pre = t_steps.build_step(cfg, mesh, ShapeConfig("p", 8, 2, "prefill"),
                             dtype=torch.float32)
    logits, cache = pre.fn(pre.place(p), toks, {})
    want, want_cache = transformer.prefill(p, toks, cfg)
    assert torch.equal(logits, want)
    assert all(torch.equal(cache[k], want_cache[k]) for k in want_cache)
    dec = t_steps.build_step(cfg, mesh, ShapeConfig("d", 8, 2, "decode"))
    tok = torch.argmax(logits, -1)
    got = dec.fn(dec.place(p), cache, tok, 8)[0]
    assert torch.equal(got, transformer.decode_step(p, cache, tok, 8, cfg)[0])


# ------------------------------------------------- example inputs vs JAX


def _torch_dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _flat_sds(tree, pre=""):
    """A JAX SDS tree -> {port key: (shape, dtype name, spec tuple)}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_sds(v, f"{pre}{k}/"))
        return out
    return {pre[:-1]: (tuple(tree.shape), str(tree.dtype),
                       tuple(tree.sharding.spec))}


def _flat_port(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, f"{pre}{k}/"))
        return out
    return {pre[:-1]: (tree.shape, _torch_dtype_name(tree.dtype),
                       tuple(tree.sharding.spec))}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_mlmc_batch_sds_matches_train_step(arch):
    """``tests/test_steps_specs.py``'s contract, case for case, and every
    input's shape, dtype and spec against the JAX package's builders on
    a (1, 1) mesh."""
    cfg = get_reduced_config(arch)
    mesh = make_test_mesh((1, 1))
    shape = ShapeConfig("t", 16, 4, "train")
    bs = t_steps.build_train_step(cfg, mesh, shape, dtype=torch.float32)
    bm = t_steps.build_mlmc_train_step(cfg, mesh, shape,
                                       MLMCConfig(T=8, m=1, V=1e9), 1,
                                       dtype=torch.float32)
    b1, b2 = bs.inputs[2], bm.inputs[2]
    assert b1.keys() == b2.keys()
    if cfg.family in ("audio", "vlm"):
        assert "extra" in b2, "MLMC step dropped the family extra leaves"
    l1, l2 = _flat_port(b1), _flat_port(b2)
    assert l1.keys() == l2.keys()
    for k in l1:
        assert l1[k][1] == l2[k][1]
        assert l2[k][0][0] == 2 * l1[k][0][0] and l1[k][0][1:] == l2[k][0][1:]
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jshape = JShape("t", 16, 4, "train")
    jcfg = j_reduced_config(arch)
    for port, ref in (
            (bs, j_steps.build_train_step(jcfg, jmesh, jshape,
                                          dtype=jnp.float32)),
            (bm, j_steps.build_mlmc_train_step(jcfg, jmesh, jshape,
                                               JMLMC(T=8, m=1, V=1e9), 1,
                                               dtype=jnp.float32))):
        for got, want in zip(port.inputs, ref.inputs):
            if isinstance(want, tuple):  # sgd's empty state
                assert got == want
                continue
            assert _flat_port({"x": got} if not isinstance(got, dict) else got
                              ) == _flat_sds({"x": want}
                                             if not isinstance(want, dict)
                                             else want)
        assert port.name == ref.name


def test_sharding_types_match_jax():
    mesh = make_test_mesh((1, 1))
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    s = t_sharding.sds((3, 4), torch.bfloat16, mesh, ("data", None))
    assert (s.shape, s.dtype, s.sharding.spec, s.meta.device.type) == (
        (3, 4), torch.bfloat16, ("data", None), "meta")
    named = t_sharding.named(mesh, {"a": ("data",), "b": {"c": ()}})
    assert named["b"]["c"] == t_sharding.NamedSharding(mesh, ())
    for arch in FAMILY_ARCHS:
        for kind in ("train", "prefill"):
            got = t_sharding.batch_sds(get_reduced_config(arch), mesh, 4, 16,
                                       kind=kind, dtype=torch.float32)
            want = j_sharding.batch_sds(j_reduced_config(arch), jmesh, 4, 16,
                                        kind=kind, dtype=jnp.float32)
            assert _flat_port(got[1]) == _flat_sds(want[1]), (arch, kind)


@pytest.mark.parametrize("env", [{}, {"REPRO_ATTN_IMPL": "chunked"},
                                 {"REPRO_ATTN_SEQ_SHARD": "data",
                                  "REPRO_MOE_GROUP": "0",
                                  "REPRO_MOE_EXPERT_SHARD": "data"}],
                         ids=["default", "chunked", "overrides"])
def test_perf_cfg_matches_jax(env, monkeypatch):
    """``_perf_cfg`` on model axes of 1, 2 and 4 ranks: SmolLM-360M (15 /
    5 heads: the q-sequence split on a 2-rank 'model' axis), qwen2-moe (60
    experts) and qwen3-0.6b, with the JAX package's environment
    overrides."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fields = ("attn_impl", "attn_seq_shard", "moe_token_group",
              "moe_expert_shard")
    for arch in ("smollm-360m", "qwen2-moe-a2.7b", "qwen3-0.6b"):
        for ms in (1, 2, 4):
            stand_in = Mesh(("data", "model"), (1, ms))
            got = t_steps._perf_cfg(get_config(arch), stand_in)
            want = j_steps._perf_cfg(j_get_config(arch), stand_in)
            assert [getattr(got, f) for f in fields] == [
                getattr(want, f) for f in fields], (arch, ms)
    smollm = t_steps._perf_cfg(get_config("smollm-360m"),
                               Mesh(("data", "model"), (4, 2)))
    assert smollm.attn_seq_shard == env.get(
        "REPRO_ATTN_SEQ_SHARD", "" if env.get("REPRO_ATTN_IMPL") else "model")


def test_infer_fsdp_matches_jax():
    for arch in ("smollm-360m", "qwen2.5-32b", "arctic-480b"):
        for ms in (1, 16):
            stand_in = Mesh(("data", "model"), (16, ms))
            assert t_steps._infer_fsdp(get_config(arch), stand_in) == \
                j_steps._infer_fsdp(j_get_config(arch), stand_in)


# ------------------------------------------------------------ the meshes


def test_joint_worker_axes_of_one_rank():
    mesh = make_test_mesh((1, 1, 1), ("pod", "data", "model"))
    assert mesh.coordinate(("pod", "data")) == 0
    plan = sharded.ShardPlan(mesh, ("pod", "data"), {"w": (("pod", "data"),
                                                           "model")})
    assert plan.worker_axis == ("pod", "data") and plan.n_w == 1
    assert plan.dims("w", 2) == (None, None)
    stand_in = Mesh(("pod", "data", "model"), (2, 4, 2))
    plan = sharded.ShardPlan(stand_in, ("pod", "data"),
                             {"w": (("pod", "data"), "model")})
    assert plan.dims("w", 2) == (0, 1) and plan.n_w == 8
    assert sharded.ShardPlan(stand_in, ("data",), None).worker_axis == "data"

    class RankOf:  # a mesh as one rank sees it: shapes and coordinates only
        axis_names, shape = ("pod", "data", "model"), {"pod": 2, "data": 4,
                                                       "model": 2}

        def coordinate(self, axis):
            return {("pod", "data"): 5, "model": 1}[axis]

    plan = sharded.ShardPlan(RankOf(), ("pod", "data"),
                             {"w": (("pod", "data"), "model")})
    block = plan.block("w", torch.arange(16 * 6).reshape(16, 6), 0)
    assert plan.n_w == 8 and block.tolist() == [[63, 64, 65], [69, 70, 71]]
    with pytest.raises(ValueError, match="no joint group"):
        stand_in.group(("pod", "data"))


def test_scope_plans_split_the_specs():
    cfg = reduced(get_config("smollm-360m"))
    mesh = Mesh(("data", "model"), (4, 2))
    specs, plans = t_sharding.plan_params(cfg, mesh, fsdp=True,
                                          dtype=torch.float32)
    scopes = sharded.scope_plans(mesh, specs)
    assert set(scopes["top"].specs) == set(plans["top"])
    assert set(scopes["blocks"].specs) == set(plans["blocks"])
    for key, fa in plans["blocks"].items():
        assert scopes["blocks"].dims(key)[0] == (None if fa < 0 else fa), key
    for key, fa in plans["top"].items():
        assert scopes["top"].dims(key)[0] == (None if fa < 0 else fa), key


def test_optimizer_state_places_and_sds(monkeypatch):
    cfg = reduced(get_config("smollm-360m"))
    mesh = make_test_mesh((1, 1))
    from repro_torch.optim.optimizers import adam
    step = t_steps.build_train_step(cfg, mesh, ShapeConfig("t", 8, 2, "train"),
                                    opt=adam(1e-3), dtype=torch.float32)
    _, opt_in, _, maskf = step.inputs
    assert set(opt_in) == {"m", "v", "t"} and opt_in["t"].shape == ()
    assert maskf.shape == (1,) and maskf.dtype == torch.float32
    p = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    state = step.place(adam(1e-3).init(p))
    assert set(state["m"]) == set(p) and state["t"].shape == ()
    assert dataclasses.is_dataclass(step) and step.name.startswith("train[")
    assert sgd(0.1).init(p) == step.place(())
