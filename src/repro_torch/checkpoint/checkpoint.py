"""Carry checkpoints in the JAX package's layout (``repro/checkpoint``): an
``.npz`` of the carry's leaves under their key paths and a ``.json`` with
the step and the keys, so a carry saved by either package loads in the
other.

A key path joins the dict keys and sequence indices from the root with
"/", dict keys in sorted order (``"0/w1"``, ``"1/m/b2"``, ``"1"`` for a bare
scalar optimizer state), as ``jax.tree_util.tree_flatten_with_path`` names
them. Leaves are copied to the host; bfloat16 is stored as float32, and a
load casts every leaf back to the dtype and device of the carry it loads
into.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) of a nest of dicts, lists and tuples, in the JAX
    package's order; None holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree``'s leaves to ``path`` (.npz) and its step and keys to
    the ``.json`` beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    meta = {"step": step, "keys": sorted(flat.keys())}
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump(meta, f)


def checkpoint_step(path: str) -> int:
    """The round recorded in a checkpoint's ``.json``: where the saved carry
    left off."""
    with open(path.removesuffix(".npz") + ".json") as f:
        return int(json.load(f)["step"])


def latest_checkpoint(directory: str, prefix: str = ""):
    """``(path, step)`` of the highest-step checkpoint under ``directory``
    (basename filtered by ``prefix``), or None if there is none. A checkpoint
    is the ``.npz``/``.json`` pair ``save_checkpoint`` writes; a lone half of
    a pair (a kill mid-write) is skipped."""
    best = None
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    for name in names:
        if not name.endswith(".json") or not name.startswith(prefix):
            continue
        base = os.path.join(directory, name.removesuffix(".json"))
        if not os.path.exists(base + ".npz"):
            continue
        try:
            step = checkpoint_step(base)
        except (OSError, ValueError, KeyError):
            continue
        if best is None or step > best[1]:
            best = (base, step)
    return best


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf of ``like`` read
    from its key path, its shape checked, cast to its dtype and put on its
    device (numpy leaves stay numpy)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def restore(tree, prefix):
        if isinstance(tree, dict):
            return {k: restore(tree[k], prefix + (str(k),)) for k in tree}
        if isinstance(tree, (list, tuple)):
            out = [restore(v, prefix + (str(i),)) for i, v in enumerate(tree)]
            return type(tree)(out) if isinstance(tree, list) else tuple(out)
        if tree is None:
            return None
        key = "/".join(prefix)
        arr = data[key]
        assert arr.shape == tuple(tree.shape), (key, arr.shape, tree.shape)
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(dtype=tree.dtype,
                                                      device=tree.device)
        return arr.astype(np.asarray(tree).dtype)

    return restore(like, ())
