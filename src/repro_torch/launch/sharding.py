"""Path-based sharding rules, the port of the JAX package's
``launch/sharding.py``: the model-parallel dim of each parameter, the FSDP
dim over the worker axes, and the specs of optimizer state, batches and
the decode cache.

A spec is a plain tuple with one entry a dim, each None, an axis name or a
tuple of axis names: the counterpart of a ``PartitionSpec``. Spec trees
are keyed as the port's trees are: a parameter dict's specs by the same
flat "/" keys (``"blocks/b0/mix/wq"``), a batch's and a cache's by theirs.
A mesh is anything with ``axis_names`` and a ``shape`` dict
(``launch.mesh.Mesh``). ``core/sharded.ShardPlan`` applies a parameter
spec tree on a ``(workers, 'model')`` mesh (``run_dynabro_scan(
param_specs=)``).

The counterparts of the JAX package's sharding types, for the Mode B step
builders (``launch/steps.py``): ``named`` pairs each spec with its mesh
(``NamedSharding``), and ``sds``, ``sds_tree`` and ``batch_sds`` describe
a step's inputs as ``SDS``, a tensor on the ``meta`` device (shape and
dtype, nothing allocated) with its sharding, as a ``ShapeDtypeStruct``
with a ``NamedSharding`` does there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharded import fsdp_axis_for
from repro_torch.models import transformer

Spec = Tuple  # one entry a dim: None, an axis name or a tuple of names

# leaf name -> preferred model-sharded dim (checked for divisibility)
_MODEL_AXIS = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 0,
    "bq": 0, "bk": 0, "bv": 0,
    "w1": 1, "w3": 1, "w2": 0,
    "we1": 2, "we3": 2, "we2": 1,
    "in_proj": 1, "out_proj": 0, "x_proj": 0, "dt_proj": 1,
    "conv_w": 1, "conv_b": 0, "A_log": 0, "D": 0, "dt_bias": 0,
    "wg": 1, "wr": 1,
    "embed": 0, "unembed": 1, "dec_pos": 1,
}


def model_axis_rule(path_names: Tuple[str, ...], shape,
                    model_size: int) -> Optional[int]:
    """The dim of a leaf (named by ``path_names``, the parts of its key;
    ``shape`` a layer's, without a stacked group dim) split over 'model',
    or None."""
    name = path_names[-1] if path_names else ""
    ax = _MODEL_AXIS.get(name)
    if name == "wv" and "mlp" in path_names:  # rwkv channel-mix wv: (F, D)
        ax = 0
    if name in ("we1", "we2", "we3") and shape and shape[0] % model_size == 0:
        ax = 0  # expert parallelism when E divides the model axis
    if ax is None or ax >= len(shape):
        return None
    if shape[ax] % model_size != 0:
        return None
    if math.prod(shape) < (1 << 14):
        return None
    return ax


def _worker_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a != "model")


def _worker_count(mesh) -> int:
    return math.prod(mesh.shape[a] for a in _worker_axes(mesh))


def abstract_params(cfg: ModelConfig,
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The parameters of ``cfg`` as tensors on the ``meta`` device: their
    names, shapes and dtypes with nothing allocated and nothing drawn, at
    any model's published size."""
    return {name: torch.empty(shape, dtype=dt, device="meta")
            for name, (shape, _, dt)
            in sorted(transformer._leaf_specs(cfg, dtype).items())}


def plan_params(cfg: ModelConfig, mesh, *, fsdp: bool, dtype=torch.bfloat16):
    """Returns (specs, plans):
      specs: leaf name -> spec tuple, over the full (stacked) parameters;
      plans: {"top": {name: int}, "blocks": {name under "blocks/": int}},
             each leaf's FSDP dim in a layer's view (a group slice for
             "blocks"), -1 when it is replicated.
    A leaf under "blocks/" carries a leading group dim (None in its spec);
    every other leaf, the audio encoder's stacked layers included, is
    planned on its whole shape, as in the JAX package."""
    model_size = mesh.shape["model"]
    waxes = _worker_axes(mesh)
    m = _worker_count(mesh)
    specs, plans = {}, {"top": {}, "blocks": {}}
    for name, leaf in abstract_params(cfg, dtype).items():
        names = tuple(name.split("/"))
        stacked = names[0] == "blocks"
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        ma = model_axis_rule(names, shape, model_size)
        fa = fsdp_axis_for(shape, m, ma) if fsdp else None
        spec = [None] * len(shape)
        if ma is not None:
            spec[ma] = "model"
        if fa is not None:
            spec[fa] = waxes if len(waxes) > 1 else waxes[0]
        if stacked:
            spec = [None] + spec
        specs[name] = tuple(spec)
        if stacked:
            plans["blocks"][name[len("blocks/"):]] = -1 if fa is None else fa
        else:
            plans["top"][name] = -1 if fa is None else fa
    return specs, plans


def _map_specs(fn, spec_tree):
    """``fn`` on each spec of a nest of dicts of spec tuples."""
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    return fn(spec_tree)


def strip_model(spec_tree):
    """The specs without their 'model' entries (None in their place), for
    regions split over the worker axes only."""
    return _map_specs(lambda s: tuple(None if e == "model" else e for e in s),
                      spec_tree)


def opt_specs(opt_state, param_specs):
    """Optimizer-state specs: the param specs for param-shaped state
    (momentum, adam's moments), () for scalars, () for sgd's empty state.
    ``opt_state`` is an optimizer's ``init`` of the parameters (of
    ``abstract_params``, say)."""
    state = opt_state
    if isinstance(state, tuple) and not state:  # sgd
        return ()
    if isinstance(state, dict) and set(state) == {"m", "v", "t"}:  # adam
        return {"m": param_specs, "v": param_specs, "t": ()}
    if isinstance(state, dict) and set(state) == set(param_specs):  # momentum
        return param_specs
    if isinstance(state, dict):
        return {k: () for k in state}
    return ()  # adagrad-norm's scalar


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec tuple over a mesh."""

    mesh: Any
    spec: Spec


@dataclasses.dataclass(frozen=True, eq=False)
class SDS:
    """An input's shape and dtype (``meta``, a tensor on the ``meta``
    device) and its sharding: the port's ``ShapeDtypeStruct``."""

    meta: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self) -> tuple:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as a ``NamedSharding`` over ``mesh``."""
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def sds(shape, dtype, mesh, spec) -> SDS:
    return SDS(torch.empty(tuple(shape), dtype=dtype, device="meta"),
               NamedSharding(mesh, spec))


def sds_tree(shapes, specs, mesh):
    """``SDS`` for a nest of dicts and tuples of tensors (``abstract_params``,
    an optimizer's state of them) and the matching nest of specs."""
    if isinstance(shapes, dict):
        return {k: sds_tree(v, specs[k], mesh) for k, v in shapes.items()}
    if isinstance(shapes, tuple):
        return tuple(sds_tree(a, s, mesh) for a, s in zip(shapes, specs))
    return sds(shapes.shape, shapes.dtype, mesh, specs)


def batch_sds(cfg: ModelConfig, mesh, global_batch: int, seq_len: int, *,
              kind: str = "train", dtype=torch.bfloat16):
    """(specs, example) of the input batch: the one builder both Mode B
    train-step builders draw their batch specs and example ``SDS`` from, so
    the family's ``extra`` leaves (audio frames, VLM patches) are in
    both."""
    spec = batch_specs(cfg, mesh, global_batch, kind)
    B = global_batch
    ex = {"tokens": sds((B, seq_len), torch.int32, mesh, spec["tokens"])}
    if kind == "train":
        ex["labels"] = sds((B, seq_len), torch.int32, mesh, spec["labels"])
    if "extra" in spec:
        extra = {}
        if cfg.family == "audio":
            extra["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), dtype,
                                  mesh, spec["extra"]["frames"])
        if cfg.family == "vlm":
            extra["patches"] = sds((B, cfg.n_image_tokens, cfg.d_model),
                                   dtype, mesh, spec["extra"]["patches"])
        ex["extra"] = extra
    return spec, ex


def batch_specs(cfg: ModelConfig, mesh, global_batch: int, kind: str):
    """Specs of the input batch: the batch dim over the worker axes where
    they divide it."""
    waxes = _worker_axes(mesh)
    m = _worker_count(mesh)
    b_ax = (waxes if len(waxes) > 1 else waxes[0]) if global_batch % m == 0 \
        else None
    tok = (b_ax, None) if kind != "decode" else (b_ax,)
    spec = {"tokens": tok, "labels": (b_ax, None)}
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = (b_ax, None, None)
    if cfg.family == "vlm":
        extra["patches"] = (b_ax, None, None)
    if kind == "train":
        if extra:
            spec["extra"] = extra
        return spec
    if kind == "prefill":
        return {"tokens": tok, **({"extra": extra} if extra else {})}
    return {"tokens": tok}


def cache_specs(cfg: ModelConfig, mesh, global_batch: int):
    """(the decode cache's shapes at one position, ``leaf_spec(name,
    leaf)``): a leaf's spec puts the batch dim over 'data' where it divides
    and the head, channel or state dim over 'model' (the JAX package's
    rule, which reads the 'data' axis)."""
    model_size = mesh.shape["model"]
    data_ok = global_batch % mesh.shape["data"] == 0

    def leaf_spec(name: str, leaf) -> Spec:
        shape = tuple(leaf.shape)  # (n_groups, B, ...)
        last = name.split("/")[-1]
        spec = [None] * len(shape)
        if data_ok and shape[1] % mesh.shape["data"] == 0:
            spec[1] = "data"
        if last in ("k", "v"):  # (g, B, S, KV, hd)
            if shape[3] % model_size == 0:
                spec[3] = "model"
            elif shape[2] % model_size == 0:
                spec[2] = "model"
        elif last == "conv":  # (g, B, k-1, di)
            if shape[3] % model_size == 0:
                spec[3] = "model"
        elif last in ("ssm", "state", "prev"):  # (g, B, di | H | D, ...)
            if shape[2] % model_size == 0:
                spec[2] = "model"
        return tuple(spec)

    return transformer.init_cache(cfg, global_batch, 1, device="meta"), leaf_spec


def cache_spec_tree(cfg: ModelConfig, mesh, batch: int, seq_len: int):
    """(the decode cache's leaves on the ``meta`` device, their specs)."""
    shapes = transformer.init_cache(cfg, batch, seq_len, device="meta")
    _, leaf_spec = cache_specs(cfg, mesh, batch)
    return shapes, {k: leaf_spec(k, v) for k, v in shapes.items()}
