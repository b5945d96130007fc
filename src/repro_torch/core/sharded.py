"""The sharded substrate of the compiled drivers, the port of the JAX
package's ``core/sharded.py`` but its Mode B robust step: Mode A's worker
gather and the model zoo's GSPMD path (``ShardPlan``).

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
them. The rest of the reference file, the robust gathers and the param
hook of Mode B's step, is ROADMAP.md queue 1's 'Multi-device' (b).
"""
from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

GATHERS = {"gathers": 0, "seconds": 0.0}
COLLECTIVES = {"param_gathers": 0, "exchanges": 0, "sums": 0, "seconds": 0.0}
F32 = torch.float32


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
    worker stacks are still split).

    A rank at ``(w, c)`` holds, of each leaf, block w of its FSDP dim and
    block c of its model dim (the whole dim where the spec has none), and
    of the workers block w (``shard``). Every rank of the mesh calls every
    method together, in the same order."""

    def __init__(self, mesh, worker_axis: str, specs=None):
        self.mesh, self.worker_axis = mesh, worker_axis
        self.specs = None if specs is None else dict(specs)
        self.n_w, self.n_m = mesh.shape[worker_axis], mesh.shape["model"]

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

    def _all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *x.shape): every rank's ``x`` along ``axis``, in rank order;
        its host seconds added to ``COLLECTIVES``."""
        out = x.new_empty((self.mesh.shape[axis],) + tuple(x.shape))
        x = x.contiguous()
        COLLECTIVES["seconds"] += _host_seconds(lambda: dist.all_gather(
            list(out.unbind(0)), x, group=self.mesh.group(axis)), x)
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
            pieces = unpack([self._all_gather(f, axis) for f in flats], layout)
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
            COLLECTIVES["seconds"] += _host_seconds(
                lambda: dist.all_to_all_single(recv, send, group=group), send)
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
            table = self._all_gather(flat, "model")
        table = (self._all_gather(table, self.worker_axis) if self.n_w > 1
                 else table[None])  # (n_w, n_m or 1, D)
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

    def sq_norm(self, tree) -> torch.Tensor:
        """Σ‖leaf‖² of a tree of this rank's blocks, over the whole leaves
        (``optim.optimizers``' ``_global_norm_sq``)."""
        return self.total({k: torch.sum(torch.square(v.to(F32)))
                           for k, v in tree.items()})

    def norm(self, tree) -> torch.Tensor:
        """The global L2 norm (``core.mlmc.tree_norm``) of a tree of blocks."""
        return torch.sqrt(self.sq_norm(tree))
