"""Plain PyTorch versions of the coordinate-wise reduce kernel.

The CPU path of every wrapper in ``kernels/fused.py``, and what
``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


def cwmed_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (m, d) -> (d,) coordinate-wise median (float32).

    Sorts and takes the middle row, or the mean of the two middle rows when m
    is even (``torch.median`` returns the lower one). A column holding a NaN
    gives NaN, as ``jnp.median`` does."""
    xs = torch.sort(x.to(torch.float32), dim=0).values
    m = xs.shape[0]
    med = xs[m // 2] if m % 2 else 0.5 * (xs[m // 2 - 1] + xs[m // 2])
    return torch.where(torch.isnan(xs).any(0), torch.nan, med)


def cwtm_ref(x: torch.Tensor, trim) -> torch.Tensor:
    """x: (m, d) -> (d,) trimmed mean dropping ``trim`` lowest/highest.

    ``trim`` may be an int or an integer tensor. One masked sum over all m
    sorted rows serves both, as in the JAX reference: a trimmed row holding
    +-inf or NaN contributes 0 * inf = NaN."""
    m = x.shape[0]
    xs = torch.sort(x.to(torch.float32), dim=0).values
    i = torch.arange(m, device=x.device)[:, None]
    keep = ((i >= trim) & (i < m - trim)).to(torch.float32)
    denom = m - 2 * trim  # a float32 division either way, with no host copy
    if isinstance(denom, torch.Tensor):
        denom = denom.to(torch.float32)
    return (xs * keep).sum(0) / denom


def cw_mean_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (m, d) -> (d,) mean over the rows (float32)."""
    return torch.mean(x.to(torch.float32), dim=0)
