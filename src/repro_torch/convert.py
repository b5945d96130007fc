"""Carry parameter dicts between the JAX package and this one as numpy
arrays. The classification task uses the same names and layouts in both
(``dict[str, array]``), so nothing is transposed; the model zoo's nested
JAX tree maps to the port's flat dict, its keys the tree paths joined with
"/" (``zoo_params_from_numpy`` / ``zoo_params_to_numpy``)."""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree: Mapping[str, np.ndarray],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """numpy (or array-like) leaves -> tensors on ``device``, same dtypes."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(tree[k])).to(dev) for k in sorted(tree)}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors -> host numpy arrays, same dtypes."""
    return {k: params[k].detach().cpu().numpy() for k in sorted(params)}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def zoo_params_from_numpy(tree: Mapping[str, Any],
                          device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's nested ``models.init_params`` tree (numpy or
    array-like leaves) -> the port's flat dict on ``device``, same dtypes:
    ``{"blocks": {"b0": {"mix": {"wq": a}}}}`` -> ``{"blocks/b0/mix/wq":
    tensor}``."""
    return params_from_numpy(_flatten(tree), device)


def zoo_params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat model dict -> the JAX package's nested tree of numpy
    arrays, same dtypes (the inverse of ``zoo_params_from_numpy``)."""
    tree: Dict[str, Any] = {}
    for key, leaf in params_to_numpy(params).items():
        *path, name = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree
