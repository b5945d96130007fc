"""Plain PyTorch versions of the aggregation kernels: the coordinate-wise
reduce (``csrc/cw_reduce.cu``), the pairwise and cross squared distances
(``csrc/sqdist.cu``) and the weighted combine with its mix-then-reduce form
(``csrc/combine.cu``).

The CPU path of every wrapper in ``kernels/fused.py``, and what
``chip_smoke.py`` holds each CUDA kernel against on the card. The distance
and combine versions copy the JAX package's ``repro/kernels/ref.py``.
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


def clip_trim(trim, m: int):
    """``trim`` clipped to [0, (m-1)//2], the most a two-sided trim of m rows
    may drop: an int, or an integer tensor clipped where it lies (no host
    copy)."""
    if isinstance(trim, torch.Tensor):
        return torch.clamp(trim, 0, (m - 1) // 2)
    return min(max(int(trim), 0), (m - 1) // 2)


def cw_reduce_ref(x: torch.Tensor, mode: str, trim=0) -> torch.Tensor:
    """x: (m, d) -> (d,) reduced by ``mode``: "med", "tm" (``trim``, an int
    or an integer tensor, clipped by ``clip_trim``) or "mean"."""
    if mode == "med":
        return cwmed_ref(x)
    if mode == "tm":
        return cwtm_ref(x, clip_trim(trim, x.shape[0]))
    if mode == "mean":
        return cw_mean_ref(x)
    raise ValueError(f"unknown reduce mode {mode!r}")


def cw_reduce_lanes_ref(x: torch.Tensor, mode: str, trim=0) -> torch.Tensor:
    """x: (C, m, d) -> (C, d), row c the ``cw_reduce_ref`` of lane c's
    stack x[c]; ``trim`` an int for every lane or an integer tensor of C
    elements, lane c's at c."""
    trims = (trim.reshape(-1) if isinstance(trim, torch.Tensor)
             else [trim] * x.shape[0])
    return torch.stack([cw_reduce_ref(x[c], mode, trims[c])
                        for c in range(x.shape[0])])


def pairwise_sqdist_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (m, d) -> (m, m) squared L2 distances (float32), by the Gram
    expansion ``sq_i + sq_j - 2 x_i.x_j`` clamped at 0 (NaN stays NaN)."""
    x = x.to(torch.float32)
    sq = torch.sum(x * x, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.clamp(d2, min=0.0)


def cross_sqdist_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x: (m, d), y: (k, d) -> (m, k) squared L2 distances (float32).

    Direct subtraction, never the Gram expansion: Weiszfeld iterates sit
    close to the points, where the expansion cancels catastrophically in
    float32 (distances ~1e-7 ||x||^2 round to 0 and GeoMed degenerates to a
    mean). k is tiny (1 for GeoMed), so the (m, k, d) broadcast is cheap."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    d2 = torch.sum(torch.square(x[:, None, :] - y[None, :, :]), dim=-1)
    return torch.clamp(d2, min=0.0)


def weighted_combine_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (m, d), w: (k, m) -> (k, d) = w @ x (float32)."""
    return w.to(torch.float32) @ x.to(torch.float32)


def combine_reduce_ref(x: torch.Tensor, w: torch.Tensor, mode: str,
                       trim=0) -> torch.Tensor:
    """The rows of ``w @ x`` (w: (k, m)) reduced coordinate-wise to (d,) by
    ``mode``: "med", "tm" (``trim``, an int or an integer tensor, rows
    dropped at each end, clipped as ``clip_trim`` does) or "mean". The two
    steps the separate plain versions take: combine, then reduce."""
    return cw_reduce_ref(weighted_combine_ref(x, w), mode, trim)
