"""Carry parameter dicts between the JAX package and this one as numpy
arrays. The classification task uses the same names and layouts in both
(``dict[str, array]``), so nothing is transposed; the model zoo's nested
JAX tree maps to the port's flat dict, its keys the tree paths joined with
"/" (``zoo_params_from_numpy`` / ``zoo_params_to_numpy``), and its decode
cache, a tree of the same kind under the layer names, to the port's flat
cache (``zoo_cache_from_numpy`` / ``zoo_cache_to_numpy``). bfloat16 leaves
(numpy's ``ml_dtypes.bfloat16``) keep their dtype and bits both ways."""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # numpy has no such dtype: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # JAX's bfloat16 numpy dtype, needed only here
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Mapping[str, np.ndarray],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """numpy (or array-like) leaves -> tensors on ``device``, same dtypes."""
    dev = resolve_device(device)
    return {k: _from_numpy(tree[k]).to(dev) for k in sorted(tree)}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors -> host numpy arrays, same dtypes."""
    return {k: _to_numpy(params[k]) for k in sorted(params)}


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
    return _nest(params_to_numpy(params))


def zoo_cache_from_numpy(tree: Mapping[str, Any],
                         device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's decode cache (``models.init_cache``, ``prefill``,
    ``decode_step``; numpy or array-like leaves stacked over n_groups) ->
    the port's flat cache on ``device``, same dtypes: ``{"b0": {"mix": {"k":
    a}}}`` -> ``{"b0/mix/k": tensor}``."""
    return params_from_numpy(_flatten(tree), device)


def zoo_cache_to_numpy(cache: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat cache -> the JAX package's nested cache tree of numpy
    arrays, same dtypes (the inverse of ``zoo_cache_from_numpy``)."""
    return _nest(params_to_numpy(cache))


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *path, name = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree
