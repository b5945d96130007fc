"""The sharded substrate of Mode A's drivers, the first part of the port of
the JAX package's ``core/sharded.py``: the worker gather.

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
gather is done to the moment the gathered buffers are written). The rest of
the reference file, the robust gathers of the GSPMD path, is Mode B
(ROADMAP.md queue 1, 'Multi-device').
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

GATHERS = {"gathers": 0, "seconds": 0.0}


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


def all_gather_into(bufs, flats, group) -> None:
    """Gather each rank's ``flats`` into ``bufs`` in rank order, one
    collective a buffer; counted in ``GATHERS``."""
    cuda = flats[0].is_cuda
    if cuda:  # the card's writes of flats are done before the host sends
        torch.cuda.current_stream(flats[0].device).synchronize()
    t0 = time.perf_counter()
    for buf, flat in zip(bufs, flats):
        dist.all_gather(list(buf.unbind(0)), flat, group=group)
    if cuda:
        torch.cuda.current_stream(flats[0].device).synchronize()
    GATHERS["gathers"] += 1
    GATHERS["seconds"] += time.perf_counter() - t0


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


def gather_objects(obj, mesh, axis: str) -> list:
    """Every rank's ``obj`` along ``mesh``'s ``axis``, in rank order (a
    pickled all-gather: tensors in ``obj`` should be on the CPU)."""
    n = mesh.shape[axis]
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=mesh.group(axis))
    return out
