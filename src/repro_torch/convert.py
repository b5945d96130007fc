"""Carry parameter dicts between the JAX package and this one as numpy
arrays. Both use the same names and layouts (``dict[str, array]``), so
nothing is transposed."""
from __future__ import annotations

from typing import Dict, Mapping

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
