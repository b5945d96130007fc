"""GShard/Switch-style Mixture-of-Experts FFN with capacity-based dispatch;
the port of the JAX package's ``models/moe.py``.

Dense einsum dispatch: tokens x experts x capacity one-hots. The top-k
comes from a stable descending sort, so a tie picks the lower expert index
as ``jax.lax.top_k`` does, and every one-hot is a comparison with an
``arange``: each backward is then a product, never a scatter, so a rerun on
a card gives the same bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.func import vmap

F32 = torch.float32


def _capacity(tokens: int, top_k: int, factor: float, E: int) -> int:
    """Per-expert token capacity ⌊tokens·k·factor/E⌋, nudged so f64
    representation error cannot truncate an exact boundary one token short
    (int(0.3 * 10) == 2): the local twin of ``agg_engine.count_floor``
    (models/ stays import-independent of core/)."""
    # jaxlint: disable=JXL003 -- sanctioned nudged-floor helper, see docstring
    return max(1, math.floor(tokens * top_k * factor / E + 1e-5))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_dispatch(probs: torch.Tensor, top_k: int, capacity: int):
    """probs: (N, E) -> dispatch (N, E, C), combine (N, E, C), aux."""
    N, E = probs.shape
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :top_k]  # (N, k)
    # gates re-read probs through one-hots: the transpose is then a product
    gates = torch.einsum("nke,ne->nk", _one_hot(idx, E, probs.dtype), probs)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    dev = probs.device
    dispatch = torch.zeros((N, E, capacity), dtype=probs.dtype, device=dev)
    combine = torch.zeros((N, E, capacity), dtype=probs.dtype, device=dev)
    counts = torch.zeros((E,), dtype=torch.int32, device=dev)
    frac_dispatched = torch.zeros((E,), dtype=F32, device=dev)
    for k in range(top_k):
        m = _one_hot(idx[:, k], E, torch.int32)  # (N, E)
        pos = torch.cumsum(m, dim=0, dtype=torch.int32) - m + counts[None, :]
        counts = counts + m.sum(0, dtype=torch.int32)
        keep = (pos < capacity) & (m > 0)
        oh_pos = _one_hot(pos, capacity, probs.dtype)  # (N, E, C)
        slot = keep.to(probs.dtype)[..., None] * oh_pos
        dispatch = dispatch + slot
        combine = combine + slot * gates[:, k][:, None, None]
        frac_dispatched = frac_dispatched + m.to(F32).mean(0)
    # load-balance aux (Switch/GShard): E * sum_e mean_prob_e * mean_dispatch_e
    aux = E * torch.sum(probs.to(F32).mean(0) * frac_dispatched / max(top_k, 1))
    return dispatch, combine, aux


def _moe_group(xf: torch.Tensor, p: dict, top_k: int, capacity: int,
               act: str):
    """One token group through the experts. xf: (N, D) -> (N, D), aux."""
    logits = xf.to(F32) @ p["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _topk_dispatch(probs, top_k, capacity)
    dispatch = dispatch.to(xf.dtype)
    combine = combine.to(xf.dtype)
    xs = torch.einsum("nec,nd->ecd", dispatch, xf)  # (E, C, D)
    if act == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", xs, p["we1"]))
        h = h * torch.einsum("ecd,edf->ecf", xs, p["we3"])
    else:
        h = F.gelu(torch.einsum("ecd,edf->ecf", xs, p["we1"]),
                   approximate="tanh")
    ys = torch.einsum("ecf,efd->ecd", h, p["we2"])  # (E, C, D)
    return torch.einsum("nec,ecd->nd", combine, ys), aux


def moe_ffn(x: torch.Tensor, p: dict, *, top_k: int, capacity_factor: float,
            act: str = "swiglu", token_group: int = 0,
            expert_shard: str = "") -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). p: router (D,E), we1/we3 (E,D,F), we2 (E,F,D).

    ``token_group`` > 0 routes tokens in independent groups of that size
    (GShard-style grouping) when it divides B·S and is smaller, each at
    its own capacity; the aux is then the groups' mean. A decode step (S ==
    1) routes its B tokens as one group at capacity B, so no token is
    dropped. Returns (out (B,S,D), aux_loss scalar). ``expert_shard``, the
    mesh axis of the experts, is a sharding hint in the JAX package that
    never changes a value; the port's sharded paths compute a 'model'
    group's work on every rank of the group, so it changes nothing here
    (splitting the experts over 'model' is the tensor-parallel forward,
    ROADMAP.md queue 1)."""
    B, S, D = x.shape
    E = p["router"].shape[1]
    N = B * S
    xf = x.reshape(N, D)
    if S == 1:
        out, aux = _moe_group(xf, p, top_k, N, act)
        return out.reshape(B, S, D), aux
    if token_group and N > token_group and N % token_group == 0:
        capacity = _capacity(token_group, top_k, capacity_factor, E)
        xg = xf.reshape(N // token_group, token_group, D)
        out, auxs = vmap(
            lambda xc: _moe_group(xc, p, top_k, capacity, act))(xg)
        return out.reshape(B, S, D), auxs.mean()
    capacity = _capacity(N, top_k, capacity_factor, E)
    out, aux = _moe_group(xf, p, top_k, capacity, act)
    return out.reshape(B, S, D), aux
