"""The sharded substrate, the port of the JAX package's ``core/sharded.py``:
Mode A's worker gather, the model zoo's GSPMD path (``ShardPlan``) and
Mode B's robust gathers and param hook (below).

The compiled drivers lay the m simulated workers across the ranks of a
worker mesh (``launch/mesh.py``): each rank computes the per-worker
gradients of its own block of workers, and the stacks are re-assembled in
rank order by an all-gather over the worker axis, so the attack and the
aggregation run on every rank exactly as the unsharded driver runs them.
The all-gather packs a tree's leaves into one (m_local, D) buffer per dtype
(one collective a dtype), and unpacks the gathered (n, m_local, D) buffer
into contiguous leaves, as the unsharded stack is laid out. On a gloo group
the collective goes through the host; gloo gathers CUDA tensors itself.

``GATHERS`` counts the gathers run (``"gathers"``) and the host seconds
spent in them (``"seconds"``: on a card from the moment the work before the
gather is done to the moment the gathered buffers are written).

``ShardPlan`` is the GSPMD path on a ``(workers, 'model')`` mesh, where the
JAX package pins shardings and lets XLA insert the collectives: a rank
stores its block of each parameter (the spec's FSDP dim split over the
worker axis, its model dim over ``'model'``), all-gathers the parameters at
a round's start, computes its block of workers' gradients on them,
exchanges the worker stacks over the worker axis (an all-to-all) so that it
holds every worker for its own coordinates, and aggregates those. Partial
statistics (distances, squared norms) are summed over the ranks holding
distinct blocks, every rank adding the same gathered partials in rank
order, so the ranks agree bitwise. ``COLLECTIVES`` counts its parameter
gathers, exchanges and sums, and their host seconds as ``GATHERS`` counts
them, split by kind (``gather_seconds``, ``exchange_seconds``,
``sum_seconds``; ``seconds`` their total).

Mode B (the JAX package's production training path, ``launch/steps.py``)
runs one worker a position of the mesh's worker axes, every parameter
FSDP-split over those axes and split over 'model' (``ShardPlan`` over the
tuple of worker axes). ``ParamHook`` applies at each point of use a
gather whose backward robust-aggregates instead of summing
(``_RobustGather``, one ``autograd.Function`` a call over a scope's
leaves): its forward is ``ShardPlan.gather``; its backward cuts the rank's
'model' block of each cotangent, exchanges the workers' blocks
(``ShardPlan.exchange``: one all-to-all a dtype, the leaves kept whole over
the workers sent whole, a stack gather), attacks the Byzantine workers'
rows of the (m, block) stacks (``_attack_cotangent``: the honest
statistics of IPM and ALIE are per coordinate, so attacking the exchanged
stacks is the reference's attack before the exchange, exactly) and reduces
the stacks with the coordinate-wise rule, one ``tree_cw_reduce`` launch a
scope of up to 32 leaves (K1 reduces each column on its own: the values of
aggregating leaf by leaf). The mask arrives as data; the attacked rows are
the exchanged stack's, so no worker index is needed. The JAX package's
``tree_sq_norm`` and ``make_global_norm`` are ``ShardPlan.sq_norm`` and
``ShardPlan.norm``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.core.agg_engine import get_aggregator

GATHERS = {"gathers": 0, "seconds": 0.0}
COLLECTIVES = {"param_gathers": 0, "exchanges": 0, "sums": 0, "seconds": 0.0,
               "gather_seconds": 0.0, "exchange_seconds": 0.0,
               "sum_seconds": 0.0}
F32 = torch.float32


def _collective_seconds(kind: str, secs: float) -> None:
    COLLECTIVES[kind + "_seconds"] += secs
    COLLECTIVES["seconds"] += secs


def pack(tree, dim: int = 0):
    """The leaves of ``tree`` with their worker axis ``dim`` moved first
    and flattened behind it, concatenated into one (m_local, D) tensor per
    dtype; returns (those tensors, the layout ``unpack`` reads)."""
    leaves, spec = tree_flatten(tree)
    groups = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    flats, layout = [], []
    for idx in groups.values():
        moved = [leaves[i].movedim(dim, 0) for i in idx]
        flats.append(torch.cat([l.reshape(l.shape[0], -1) for l in moved], 1))
        layout.append((idx, [tuple(l.shape[1:]) for l in moved]))
    return flats, (spec, layout, len(leaves), dim)


def unpack(bufs, layout):
    """The tree of ``pack``'s layout from the gathered (n, m_local, D)
    buffers: each leaf's worker axis n·m_local long, back at its place, the
    leaf contiguous."""
    spec, groups, count, dim = layout
    out = [None] * count
    for buf, (idx, shapes) in zip(bufs, groups):
        full = buf.reshape(-1, buf.shape[-1])
        widths = [math.prod(s) for s in shapes]
        for i, shape, piece in zip(idx, shapes, full.split(widths, 1)):
            out[i] = piece.reshape((full.shape[0],) + shape).movedim(
                0, dim).contiguous()
    return tree_unflatten(out, spec)


def empty_buffers(flats, n: int):
    """The (n, m_local, D) buffers an all-gather of ``flats`` writes."""
    return [f.new_empty((n,) + tuple(f.shape)) for f in flats]


def _host_seconds(run, like: torch.Tensor) -> float:
    """Run the host collective ``run()``; its seconds, on a card from the
    moment the work before it is done (the card's writes of its inputs
    land before the host sends) to the moment its outputs are written."""
    cuda = like.is_cuda
    if cuda:
        torch.cuda.current_stream(like.device).synchronize()
    t0 = time.perf_counter()
    run()
    if cuda:
        torch.cuda.current_stream(like.device).synchronize()
    return time.perf_counter() - t0


def all_gather_into(bufs, flats, group) -> None:
    """Gather each rank's ``flats`` into ``bufs`` in rank order, one
    collective a buffer; counted in ``GATHERS``."""
    def run():
        for buf, flat in zip(bufs, flats):
            dist.all_gather(list(buf.unbind(0)), flat, group=group)
    GATHERS["seconds"] += _host_seconds(run, flats[0])
    GATHERS["gathers"] += 1


def gather_worker_stack(tree, mesh, axis: str, dim: int = 0):
    """(..., m_local, ...)-leaf tree -> (..., m, ...), ``dim`` the worker
    axis, the blocks of the ranks of ``mesh``'s ``axis`` in rank order."""
    n = mesh.shape[axis]
    if n == 1:
        return tree
    flats, layout = pack(tree, dim)
    bufs = empty_buffers(flats, n)
    all_gather_into(bufs, flats, mesh.group(axis))
    return unpack(bufs, layout)


def worker_block(tree, n: int, index: int, dim: int, axis: str):
    """Block ``index`` of ``n`` of the workers of a full batch tree (``dim``
    the worker axis), contiguous: the workers a rank at ``index`` on the
    worker ``axis`` computes."""
    def block(leaf):
        k, rest = divmod(leaf.shape[dim], n)
        if rest:
            raise ValueError(
                f"worker count m={leaf.shape[dim]} not divisible by the "
                f"{axis!r} mesh axis size {n}")
        return leaf.narrow(dim, index * k, k).contiguous()
    return tree_map(block, tree)


def gather_objects(obj, mesh, axis: str) -> list:
    """Every rank's ``obj`` along ``mesh``'s ``axis``, in rank order (a
    pickled all-gather: tensors in ``obj`` should be on the CPU)."""
    n = mesh.shape[axis]
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=mesh.group(axis))
    return out


# ------------------------------------------------------------ GSPMD path


def fsdp_axis_for(shape: Sequence[int], m: int, model_axis: Optional[int],
                  min_size: int = 1 << 16) -> Optional[int]:
    """The FSDP-axis rule of ``launch.sharding.plan_params``: the first dim
    (not the model dim) divisible by the worker count, on leaves of at
    least ``min_size`` elements."""
    if math.prod(shape) < min_size:
        return None
    for ax, s in enumerate(shape):
        if ax != model_axis and s % m == 0:
            return ax
    return None


class ShardPlan:
    """The GSPMD path's sharding of a parameter dict over ``mesh`` (a
    ``(worker_axis, 'model')`` mesh of more than one rank), from ``specs``:
    leaf name -> a tuple with an entry a dim, each None, ``'model'`` or the
    worker axis (its name, or a tuple of it), as ``launch.sharding.
    plan_params`` gives them; ``specs=None`` replicates every leaf (the
    worker stacks are still split). Mode B's ``worker_axis`` is the tuple
    of the mesh's worker axes (one name where there is one), taken as one
    axis (``launch.mesh.Mesh``'s joint group).

    A rank at ``(w, c)`` holds, of each leaf, block w of its FSDP dim and
    block c of its model dim (the whole dim where the spec has none), and
    of the workers block w (``shard``). Every rank of the mesh calls every
    method together, in the same order."""

    def __init__(self, mesh, worker_axis: str, specs=None):
        axes = (tuple(worker_axis) if isinstance(worker_axis, (tuple, list))
                else (worker_axis,))
        self.mesh = mesh
        self.worker_axis = axes[0] if len(axes) == 1 else axes
        self.specs = None if specs is None else dict(specs)
        self.n_w = math.prod(mesh.shape[a] for a in axes)
        self.n_m = mesh.shape["model"]

    # --------------------------------------------------------- layout

    def dims(self, key: str, ndim: Optional[int] = None):
        """(FSDP dim, model dim) of leaf ``key``, each None where the spec
        has none or its axis has one rank; ``ndim`` checks the spec's
        length."""
        if self.specs is None:
            return None, None
        if key not in self.specs:
            raise ValueError(f"param_specs has no entry for leaf {key!r}")
        spec = tuple(self.specs[key])
        if ndim is not None and len(spec) != ndim:
            raise ValueError(f"param_specs[{key!r}] = {spec} has {len(spec)} "
                             f"entries for a leaf of {ndim} dims")
        fsdp = model = None
        for d, e in enumerate(spec):
            if e in (self.worker_axis, (self.worker_axis,)):
                fsdp = d
            elif e == "model":
                model = d
            elif e is not None:
                raise ValueError(
                    f"param_specs[{key!r}] = {spec}: entry {e!r} is not "
                    f"None, 'model' or the worker axis {self.worker_axis!r}")
        return (fsdp if self.n_w > 1 else None,
                model if self.n_m > 1 else None)

    def block(self, key: str, x: torch.Tensor, lead: int,
              fsdp_too: bool = True) -> torch.Tensor:
        """This rank's block of the full leaf ``key`` behind ``lead``
        leading dims (a view); with ``fsdp_too`` False its model block
        only."""
        fsdp, model = self.dims(key, x.dim() - lead)
        for d, n, axis in ((fsdp if fsdp_too else None, self.n_w,
                            self.worker_axis), (model, self.n_m, "model")):
            if d is not None:
                size, rest = divmod(x.shape[lead + d], n)
                if rest:
                    raise ValueError(
                        f"leaf {key!r} dim {d} of size {x.shape[lead + d]} "
                        f"not divisible by the {axis!r} mesh axis size {n}")
                x = x.narrow(lead + d, self.mesh.coordinate(axis) * size, size)
        return x

    def blocks(self, tree):
        """Full params (or param-shaped state) -> this rank's blocks,
        contiguous copies."""
        return {k: self.block(k, v, 0).clone(
            memory_format=torch.contiguous_format) for k, v in tree.items()}

    def full_shape(self, key: str, shape, lead: int) -> tuple:
        """The full shape of a leaf whose blocks have ``shape``."""
        fsdp, model = self.dims(key, len(shape) - lead)
        out = list(shape)
        if fsdp is not None:
            out[lead + fsdp] *= self.n_w
        if model is not None:
            out[lead + model] *= self.n_m
        return tuple(out)

    def shard(self, tree, dim: int):
        """This rank's block of workers of a full batch (``dim`` the worker
        axis)."""
        return worker_block(tree, self.n_w,
                            self.mesh.coordinate(self.worker_axis), dim,
                            self.worker_axis)

    # ---------------------------------------------------- collectives

    def _all_gather(self, x: torch.Tensor, axis, kind: str) -> torch.Tensor:
        """(n, *x.shape): every rank's ``x`` along ``axis``, in rank order;
        its host seconds added to ``COLLECTIVES`` under ``kind``."""
        n = self.n_w if axis == self.worker_axis else self.mesh.shape[axis]
        out = x.new_empty((n,) + tuple(x.shape))
        x = x.contiguous()
        _collective_seconds(kind, _host_seconds(lambda: dist.all_gather(
            list(out.unbind(0)), x, group=self.mesh.group(axis)), x))
        return out

    def gather(self, blocks):
        """This rank's blocks -> the full params, on every rank: per axis
        ('model', then the worker axis) one all-gather a dtype of the
        blocks of the leaves split over it, packed, then joined on their
        dim."""
        out = dict(blocks)
        if not out:
            return out
        ran = False
        for axis, which in (("model", 1), (self.worker_axis, 0)):
            keys = [k for k in sorted(out)
                    if self.dims(k, out[k].dim())[which] is not None]
            if not keys:
                continue
            flats, layout = pack({k: out[k][None] for k in keys}, 0)
            pieces = unpack([self._all_gather(f, axis, "gather")
                             for f in flats], layout)
            for k in keys:
                d = self.dims(k)[which]
                out[k] = torch.cat(pieces[k].unbind(0), d)
            ran = True
        if ran:
            COLLECTIVES["param_gathers"] += 1
        return out

    def exchange(self, stack, lead: int):
        """Per-worker gradients of this rank's block of workers, leaves
        (m_local, ..., *leaf) with ``lead`` leading dims -> every worker's
        gradients at this rank's coordinates, leaves (m, ..., *block),
        contiguous, workers in order. The model block is cut locally (the
        ranks of a 'model' group computed the same workers); over the worker
        axis one all-to-all a dtype sends each rank its FSDP block, or the
        whole leaf where the leaf has no FSDP dim. The leaves are taken out
        of ``stack`` as they go, so the full stack is freed leaf by leaf.
        Gloo takes the card's tensors as they are."""
        n, out, groups = self.n_w, {}, {}
        for k in sorted(stack):
            x = self.block(k, stack.pop(k), lead, fsdp_too=False)
            if n == 1:
                out[k] = x.contiguous()
                continue
            fsdp, _ = self.dims(k)
            parts = (x.chunk(n, lead + fsdp) if fsdp is not None else (x,) * n)
            groups.setdefault(x.dtype, []).append((k, parts))
        for dtype, items in groups.items():
            m_local = items[0][1][0].shape[0]
            send = torch.stack([torch.cat([p[r].reshape(m_local, -1)
                                           for _, p in items], 1)
                                for r in range(n)])  # (n, m_local, D)
            recv = torch.empty_like(send)
            group = self.mesh.group(self.worker_axis)
            _collective_seconds("exchange", _host_seconds(
                lambda: dist.all_to_all_single(recv, send, group=group), send))
            off = 0
            for k, parts in items:
                shape = tuple(parts[0].shape[1:])
                width = math.prod(shape)
                out[k] = recv[:, :, off:off + width].reshape(
                    (n * m_local,) + shape).contiguous()
                off += width
            del send, recv
        if groups:
            COLLECTIVES["exchanges"] += 1
        return out

    def total(self, parts):
        """The sum of per-leaf partial statistics ``{leaf: partial}`` (each
        the statistic over this rank's block of the leaf) over the whole
        leaves: every rank's partials gathered, one all-gather an axis, and
        summed on every rank by ``add_partials``."""
        keys = sorted(parts)
        flat = torch.cat([parts[k].reshape(-1).to(F32) for k in keys])
        table = flat[None]
        if self.n_m > 1:
            table = self._all_gather(flat, "model", "sum")
        table = (self._all_gather(table, self.worker_axis, "sum")
                 if self.n_w > 1 else table[None])  # (n_w, n_m or 1, D)
        COLLECTIVES["sums"] += 1
        return self.add_partials(table, {k: tuple(parts[k].shape)
                                         for k in keys})

    def add_partials(self, table: torch.Tensor, shapes) -> torch.Tensor:
        """The whole leaves' statistic from ``table``, every rank's
        partials flattened and joined in sorted leaf order, (n_w, n_m, D)
        (n_m or n_w 1 where that axis has one rank), ``shapes`` each
        partial's shape by leaf: per leaf in sorted order, the partials of
        the ranks holding distinct blocks added in rank order, then the
        leaves added in order (the unsharded sum's order of leaves). Every
        rank adds the same table in the same order: the same bits."""
        out, off = None, 0
        for k in sorted(shapes):
            width = math.prod(shapes[k])
            piece = table[:, :, off:off + width]
            off += width
            fsdp, model = self.dims(k)
            terms = [piece[w, c].reshape(shapes[k])
                     for w in (range(self.n_w) if fsdp is not None else (0,))
                     for c in (range(self.n_m) if model is not None else (0,))]
            s = terms[0]
            for t in terms[1:]:
                s = s + t
            out = s if out is None else out + s
        return out

    def worker_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the worker axis of a float32 scalar that each worker
        holds: every rank's gathered, added in rank order on every rank."""
        if self.n_w == 1:
            return x
        vals = self._all_gather(x.to(F32).reshape(()), self.worker_axis, "sum")
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        return total / self.n_w

    def sq_norm(self, tree) -> torch.Tensor:
        """Σ‖leaf‖² of a tree of this rank's blocks, over the whole leaves
        (``optim.optimizers``' ``_global_norm_sq``)."""
        return self.total({k: torch.sum(torch.square(v.to(F32)))
                           for k, v in tree.items()})

    def norm(self, tree) -> torch.Tensor:
        """The global L2 norm (``core.mlmc.tree_norm``) of a tree of blocks."""
        return torch.sqrt(self.sq_norm(tree))


# ------------------------------------------------------------ Mode B


@dataclasses.dataclass(frozen=True)
class ShardedByzConfig:
    axis_names: Tuple[str, ...]  # worker axes, e.g. ('data',) or ('pod','data')
    m: int  # product of worker axis sizes
    aggregator: str = "cwmed"  # coordinate-wise: mean | cwmed | cwtm
    delta: float = 0.25
    attack: str = "none"  # none | sign_flip | ipm | alie
    attack_param: float = 0.1
    backend: str = "auto"  # agg_engine backend: ref | kernel | auto

    def __post_init__(self):
        if self.attack not in ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r}, expected one "
                             f"of {ATTACKS}")


ATTACKS = ("none", "sign_flip", "ipm", "alie")


def _make_leaf_agg(cfg: ShardedByzConfig):
    """The rule of ``cfg`` from the shared engine registry; its ``tree``
    reduces a scope's (m, block) stacks, its ``leaf`` one. Mode B aggregates
    each parameter block on its own, which is exact only for coordinate-wise
    rules, so any other rule raises ``ValueError`` here, when the step is
    built."""
    agg = get_aggregator(cfg.aggregator, delta=cfg.delta, backend=cfg.backend)
    if not agg.coordinate_wise:
        raise ValueError(
            f"sharded mode supports coordinate-wise rules, got {cfg.aggregator}")
    return agg


def _attack_cotangent(stack: Dict[str, torch.Tensor], maskf: torch.Tensor,
                      cfg: ShardedByzConfig) -> Dict[str, torch.Tensor]:
    """The workers' exchanged (m, ...) cotangent stacks with the rows of the
    workers that ``maskf`` (m,) flags (> 0.5) attacked: ``sign_flip`` -g,
    ``ipm`` -attack_param · (honest sum) / n_honest, ``alie`` mu -
    attack_param · sqrt(var + 1e-12) with the honest rows' mean and
    variance, n_honest = max(m - Σ maskf, 1); in float32, cast back to each
    leaf's dtype. The honest statistics are per coordinate, so these are
    the reference's formulas on each worker's whole cotangent."""
    if cfg.attack == "none":
        return stack
    byz = maskf > 0.5
    n_honest = torch.clamp(cfg.m - maskf.sum(), min=1.0)
    out = {}
    for k in sorted(stack):
        g = stack[k]
        gf = g.to(F32)
        b = byz.reshape((-1,) + (1,) * (g.dim() - 1))
        honest = torch.where(b, 0.0, 1.0)
        if cfg.attack == "sign_flip":
            bad = -gf
        elif cfg.attack == "ipm":
            bad = -cfg.attack_param * (honest * gf).sum(0) / n_honest
        else:  # alie (ShardedByzConfig admits no other name)
            mu = (honest * gf).sum(0) / n_honest
            var = (honest * torch.square(gf - mu)).sum(0) / n_honest
            bad = mu - cfg.attack_param * torch.sqrt(var + 1e-12)
        out[k] = torch.where(b, bad, gf).to(g.dtype)
    return out


class _RobustGather(torch.autograd.Function):
    """One call of Mode B's hook over a scope's leaves (the port of the JAX
    package's ``make_robust_gather`` / ``make_robust_replicated`` custom
    VJPs, one Function for all of a call's leaves): the forward gathers the
    rank's blocks into the full leaves (``ShardPlan.gather``), the backward
    robust-aggregates the workers' cotangents at the rank's blocks
    (``ParamHook.aggregate``). It runs inside ``torch.func.vjp`` too (a
    layer group's recompute, ``models/transformer._Group``), whose
    Functions see plain tensors, so the collectives run there."""

    @staticmethod
    def forward(hook, scope, keys, *blocks):
        full = hook.plans[scope].gather(dict(zip(keys, blocks)))
        # a leaf that no axis splits comes back as its block: a view, so
        # that autograd keeps the output apart from the input
        return tuple(full[k].view_as(b) if full[k] is b else full[k]
                     for k, b in zip(keys, blocks))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hook, ctx.scope, ctx.keys = inputs[:3]

    @staticmethod
    def backward(ctx, *cotangents):
        agg = ctx.hook.aggregate(ctx.scope, dict(zip(ctx.keys, cotangents)))
        return (None, None, None) + tuple(agg[k] for k in ctx.keys)


class ParamHook:
    """Mode B's param hook (the JAX package's ``make_param_hook``; its
    ``make_robust_gather`` and ``make_robust_replicated`` are this hook on a
    scope's FSDP-split and worker-replicated leaves, which one call takes
    together): ``hook(tree, scope)`` -> the full leaves of the rank's blocks
    ``tree``, through a ``_RobustGather``. ``plans`` maps a
    scope to its ``ShardPlan`` (``scope_plans``): "top" the leaves outside
    the layer groups, "blocks" one group's slices. ``maskf`` (m,) flags the
    Byzantine workers, as data."""

    def __init__(self, cfg: ShardedByzConfig, plans: Dict[str, ShardPlan],
                 maskf: torch.Tensor):
        self.cfg, self.plans, self.maskf = cfg, plans, maskf
        self.agg = _make_leaf_agg(cfg)

    def __call__(self, tree, scope: str):
        keys = tuple(sorted(tree))
        return dict(zip(keys, _RobustGather.apply(
            self, scope, keys, *(tree[k] for k in keys))))

    def aggregate(self, scope: str, cotangents) -> Dict[str, torch.Tensor]:
        """This worker's full-leaf ``cotangents`` -> the robust aggregate of
        every worker's at the rank's blocks: the model block cut, the
        workers' blocks exchanged, the stacks attacked, one
        ``tree_cw_reduce`` over the scope."""
        stack = self.plans[scope].exchange(
            {k: g[None] for k, g in cotangents.items()}, 1)
        return self.agg.tree(_attack_cotangent(stack, self.maskf, self.cfg))


def scope_plans(mesh, specs) -> Dict[str, ShardPlan]:
    """The hook's plans from the full params' ``specs`` (``launch.sharding.
    plan_params``): "top" every leaf not under "blocks/", "blocks" one layer
    group's slices (keyed under "blocks/", the stacked group dim dropped),
    over the tuple of ``mesh``'s worker axes."""
    waxes = tuple(a for a in mesh.axis_names if a != "model")
    pre = "blocks/"
    return {"top": ShardPlan(mesh, waxes, {k: v for k, v in specs.items()
                                           if not k.startswith(pre)}),
            "blocks": ShardPlan(mesh, waxes, {k[len(pre):]: tuple(v[1:])
                                              for k, v in specs.items()
                                              if k.startswith(pre)})}
