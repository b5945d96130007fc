"""Mode B's step builders, the port of the JAX package's ``launch/steps.py``.

* ``build_train_step``: Mode B's robust training step. Each rank of the
  mesh is one position on the worker axes (every axis but 'model'), that
  is one worker, and one block of 'model'. It holds its blocks of each
  parameter (``plan_params(fsdp=True)``'s specs: the FSDP dim split over
  the worker axes, the model dim over 'model'), keeps its worker's rows of
  the global batch (rank w of m rows ``[w·B/m, (w+1)·B/m)``, as the JAX
  package's batch spec places them), and computes its worker's loss and
  gradient on the full parameters, which ``core/sharded``'s param hook
  gathers at each point of use. The hook's backward exchanges the workers'
  cotangents, attacks the Byzantine workers' rows and reduces them with the
  coordinate-wise rule, so the gradient a rank gets is the robust aggregate
  at its blocks, which the optimizer updates (AdaGrad-Norm on the global
  norm, ``ShardPlan.sq_norm``). The loss is the workers' mean, added in rank
  order. MLMC level j is a 2^j times larger per-worker batch, so the
  aggregation applies to worker means as in Algorithm 2.
* ``build_mlmc_train_step``: Algorithm 2 at MLMC level J in Mode B, the
  robust-aggregated gradients of nested slices of the per-worker batch at
  levels 0, J−1 and J,
  the fail-safe's ‖ĝ^J − ĝ^{J−1}‖ the global norm of the rank's blocks
  (``ShardPlan.norm``).
* ``build_prefill_step`` / ``build_decode_step``: the full parameters
  gathered, then the port's ``prefill`` / ``decode_step`` on them.

Each returns a ``BuiltStep``: ``fn``, its example ``inputs``
(``launch.sharding.SDS``: the shapes, dtypes and specs of the full
arguments), its ``name``, and ``place`` / ``gather`` between full trees and
the rank's blocks. ``fn`` takes and returns the rank's blocks of the params
and of param-shaped optimizer state, and the full batch, mask, cache and
tokens. Every rank of the mesh calls it together with the same arguments,
as every collective is called (``launch/mesh.py``). The JAX package's
``_perf_cfg`` hints (``attn_seq_shard``, ``attn_batch_shard``,
``moe_expert_shard``) are placements with no effect on the values here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import sharded
from repro_torch.core.mlmc import level_prefix, mlmc_combine
from repro_torch.launch import sharding as shl
from repro_torch.launch.mesh import n_workers, worker_axes
from repro_torch.models.transformer import decode_step, loss_fn, prefill
from repro_torch.optim.optimizers import Optimizer, apply_updates, sgd

F32 = torch.float32


@dataclasses.dataclass
class BuiltStep:
    fn: Callable
    inputs: Tuple  # SDS trees, positional
    name: str
    plan: sharded.ShardPlan  # the full params' blocks on this rank

    def place(self, tree):
        """Full params, or an optimizer state holding param-shaped dicts ->
        this rank's blocks (other leaves as they are)."""
        if isinstance(tree, dict):
            if tree and set(tree) <= set(self.plan.specs):
                return self.plan.blocks(tree)
            return {k: self.place(v) for k, v in tree.items()}
        return tree

    def gather(self, blocks):
        """This rank's blocks -> the full params, on every rank."""
        return self.plan.gather(blocks)


def _perf_cfg(cfg: ModelConfig, mesh) -> ModelConfig:
    """The JAX package's per-mesh perf knobs, with its environment overrides
    (``REPRO_ATTN_IMPL``, ``REPRO_ATTN_SEQ_SHARD``, ``REPRO_MOE_GROUP``,
    ``REPRO_MOE_EXPERT_SHARD``)."""
    ms = mesh.shape["model"]
    impl = os.environ.get("REPRO_ATTN_IMPL", cfg.attn_impl)
    seq_shard = ""
    if impl == "flash" and not (cfg.n_heads % ms == 0 and cfg.n_kv_heads % ms == 0):
        # heads don't divide the model axis: shard the q-sequence dim instead
        seq_shard = os.environ.get("REPRO_ATTN_SEQ_SHARD", "model")
    tg = int(os.environ.get("REPRO_MOE_GROUP", str(cfg.moe_token_group)))
    es = ""
    if cfg.is_moe and cfg.n_experts % ms == 0 and impl == "flash":
        es = os.environ.get("REPRO_MOE_EXPERT_SHARD", "model")
    return dataclasses.replace(cfg, attn_impl=impl, attn_seq_shard=seq_shard,
                               moe_token_group=tg, moe_expert_shard=es)


# ================================================================ train


@dataclasses.dataclass
class _TrainPlumbing:
    """What the two Mode B train-step builders share: one spec and
    example-input pipeline, so that the two cannot drift apart."""
    cfg: ModelConfig
    byz: sharded.ShardedByzConfig
    specs: Any
    plan: sharded.ShardPlan
    plans: dict
    opt: Optimizer
    ospecs: Any
    opt_state_shapes: Any
    batch_ex: Any
    m: int
    dtype: Any


def _train_plumbing(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
                    level_units: int, aggregator: str, attack: str,
                    delta: float, opt: Optional[Optimizer], lr: float,
                    agg_backend: str, dtype) -> _TrainPlumbing:
    cfg = _perf_cfg(cfg, mesh)
    waxes = worker_axes(mesh)
    m = n_workers(mesh)
    B = shape.global_batch * level_units
    if B % m:
        raise ValueError(
            f"global batch {B} not divisible by m={m} workers — Mode B "
            f"shards the batch over the worker axes")
    byz = sharded.ShardedByzConfig(axis_names=waxes, m=m, aggregator=aggregator,
                                   delta=delta, attack=attack,
                                   backend=agg_backend)
    sharded._make_leaf_agg(byz)  # a rule that is not coordinate-wise raises
    specs, _ = shl.plan_params(cfg, mesh, fsdp=True, dtype=dtype)
    opt = opt or sgd(lr)
    _, batch_ex = shl.batch_sds(cfg, mesh, B, shape.seq_len, kind="train",
                                dtype=dtype)
    opt_state_shapes = opt.init(shl.abstract_params(cfg, dtype))
    ospecs = shl.opt_specs(opt_state_shapes, specs)
    return _TrainPlumbing(cfg, byz, specs, sharded.ShardPlan(mesh, waxes, specs),
                          sharded.scope_plans(mesh, specs), opt, ospecs,
                          opt_state_shapes, batch_ex, m, dtype)


def _inputs(pl: _TrainPlumbing, mesh) -> Tuple:
    params_in = shl.sds_tree(shl.abstract_params(pl.cfg, pl.dtype), pl.specs,
                             mesh)
    opt_in = shl.sds_tree(pl.opt_state_shapes, pl.ospecs, mesh)
    maskf = shl.sds((pl.m,), F32, mesh, (None,))
    return params_in, opt_in, pl.batch_ex, maskf


def _robust_grad(pl: _TrainPlumbing, blocks, batch, hook):
    """(this worker's loss, the robust aggregate of every worker's gradient
    at the rank's blocks) of the rank's worker rows ``batch``."""
    keys = sorted(blocks)
    leaves = {k: blocks[k].detach().requires_grad_() for k in keys}
    loss = loss_fn(leaves, batch, pl.cfg, param_hook=hook)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


def _update(pl: _TrainPlumbing, blocks, opt_state, g):
    updates, opt_state = pl.opt.update(
        g, opt_state, blocks, sq_norm=pl.plan.sq_norm)
    return apply_updates(blocks, updates), opt_state


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     *, aggregator: str = "cwmed", attack: str = "none",
                     level: int = 0, lr: float = 1e-3, delta: float = 0.25,
                     opt: Optional[Optimizer] = None, agg_backend: str = "auto",
                     dtype=torch.bfloat16) -> BuiltStep:
    """Mode B's step: ``fn(blocks, opt_state, batch, maskf)`` -> (blocks,
    opt_state, the workers' mean loss); ``batch`` the global batch of
    ``shape.global_batch · 2^level`` rows, ``maskf`` (m,) float32 flagging
    the Byzantine workers. A rule that is not coordinate-wise raises
    ``ValueError`` here."""
    pl = _train_plumbing(cfg, mesh, shape, level_units=2 ** level,
                         aggregator=aggregator, attack=attack, delta=delta,
                         opt=opt, lr=lr, agg_backend=agg_backend, dtype=dtype)

    def fn(blocks, opt_state, batch, maskf):
        hook = sharded.ParamHook(pl.byz, pl.plans, maskf)
        loss, g = _robust_grad(pl, blocks, pl.plan.shard(batch, 0), hook)
        with torch.no_grad():
            blocks, opt_state = _update(pl, blocks, opt_state, g)
            return blocks, opt_state, pl.plan.worker_mean(loss)

    return BuiltStep(fn, _inputs(pl, mesh),
                     f"train[{pl.cfg.arch_id}/{shape.name}/l{level}]", pl.plan)


def build_mlmc_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                          mlmc_cfg, level: int,
                          *, aggregator: str = "cwmed", attack: str = "none",
                          delta: float = 0.25, opt: Optional[Optimizer] = None,
                          lr: float = 1e-3, agg_backend: str = "auto",
                          dtype=torch.bfloat16) -> BuiltStep:
    """Algorithm 2 at MLMC level J=``level`` in Mode B: ``fn(blocks,
    opt_state, batch, maskf)`` -> (blocks, opt_state, (the workers' mean
    ``failsafe_ok`` in float32, the correction's global norm)). One round
    computes the robust-aggregated gradients of nested slices of the
    rank's (B/m)·2^J rows at levels 0, J−1 and J (two at J=1, where level
    J−1 is level 0), then ``mlmc_combine``
    guarded by the fail-safe event; a level beyond ``j_max`` drops the
    correction, as the Mode A drivers do."""
    j = level
    pl = _train_plumbing(cfg, mesh, shape, level_units=2 ** j,
                         aggregator=aggregator, attack=attack, delta=delta,
                         opt=opt, lr=lr, agg_backend=agg_backend, dtype=dtype)

    def fn(blocks, opt_state, batch, maskf):
        hook = sharded.ParamHook(pl.byz, pl.plans, maskf)
        rows = pl.plan.shard(batch, 0)

        def agg_grad(n_units):
            return _robust_grad(pl, blocks,
                                level_prefix(rows, n_units, 2 ** j), hook)[1]

        g0 = agg_grad(1)
        gjm1 = gj = None
        if 1 <= j <= mlmc_cfg.j_max:
            # level J-1 = 0 at J=1 is g0's prefix: the same gradient
            gjm1 = g0 if j == 1 else agg_grad(2 ** (j - 1))
            gj = agg_grad(2 ** j)
        with torch.no_grad():
            g, info = mlmc_combine(g0, gjm1, gj, j, mlmc_cfg,
                                   norm_fn=pl.plan.norm)
            blocks, opt_state = _update(pl, blocks, opt_state, g)
            ok = pl.plan.worker_mean(info["failsafe_ok"].to(F32))
            return blocks, opt_state, (ok, info["corr_norm"])

    return BuiltStep(fn, _inputs(pl, mesh),
                     f"mlmc_train[{pl.cfg.arch_id}/{shape.name}/J{j}]", pl.plan)


# ================================================================ inference


def _infer_fsdp(cfg: ModelConfig, mesh) -> bool:
    """Inference FSDP-splits the weights too once model-parallel alone would
    hold more than about 4 GB a rank (the JAX package's rule for its 16 GB
    chips)."""
    return cfg.param_count() * 2 / mesh.shape["model"] > 4e9


def _infer_plan(cfg: ModelConfig, mesh, dtype):
    specs, _ = shl.plan_params(cfg, mesh, fsdp=_infer_fsdp(cfg, mesh),
                               dtype=dtype)
    params_in = shl.sds_tree(shl.abstract_params(cfg, dtype), specs, mesh)
    return sharded.ShardPlan(mesh, worker_axes(mesh), specs), params_in


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                       dtype=torch.bfloat16) -> BuiltStep:
    """``fn(blocks, tokens, extra)`` -> ``prefill``'s (last logits, cache)
    on the gathered params; ``tokens`` the (B, S) global batch."""
    cfg = _perf_cfg(cfg, mesh)
    if shape.global_batch % mesh.shape["data"] == 0:
        cfg = dataclasses.replace(cfg, attn_batch_shard="data")
    plan, params_in = _infer_plan(cfg, mesh, dtype)
    _, ex = shl.batch_sds(cfg, mesh, shape.global_batch, shape.seq_len,
                          kind="prefill", dtype=dtype)

    def fn(blocks, tokens, extra):
        return prefill(plan.gather(blocks), tokens, cfg, extra=extra)

    return BuiltStep(fn, (params_in, ex["tokens"], ex.get("extra", {})),
                     f"prefill[{cfg.arch_id}/{shape.name}]", plan)


def build_decode_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                      dtype=torch.bfloat16) -> BuiltStep:
    """``fn(blocks, cache, token, pos)`` -> ``decode_step``'s (logits, new
    cache) on the gathered params; ``cache`` the full cache of ``shape``'s
    batch and length."""
    cfg = _perf_cfg(cfg.for_shape(shape), mesh)
    plan, params_in = _infer_plan(cfg, mesh, dtype)
    B, S = shape.global_batch, shape.seq_len
    cache_shapes, cache_specs = shl.cache_spec_tree(cfg, mesh, B, S)
    tok_spec = ("data",) if B % mesh.shape["data"] == 0 else (None,)

    def fn(blocks, cache, token, pos):
        return decode_step(plan.gather(blocks), cache, token, pos, cfg)

    return BuiltStep(fn, (params_in, shl.sds_tree(cache_shapes, cache_specs,
                                                  mesh),
                          shl.sds((B,), torch.int32, mesh, tok_spec),
                          shl.sds((), torch.int32, mesh, ())),
                     f"decode[{cfg.arch_id}/{shape.name}]", plan)


def build_step(cfg: ModelConfig, mesh, shape: ShapeConfig, **kw) -> BuiltStep:
    cfg = cfg.for_shape(shape)
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape)
    return build_decode_step(cfg, mesh, shape)
