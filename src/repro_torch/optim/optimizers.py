"""Optimizers, including the AdaGrad-Norm rule of Section 5 / Eq. (7):

    η_t = η₀ / sqrt(Σ_{s≤t} ‖g_s‖²)

Minimal optax-like interface over parameter dicts: ``init(params) -> state``,
``update(grads, state, params, sq_norm=None) -> (updates, state)``; apply
with ``apply_updates`` (updates are *subtracted*). Accumulators are
float32. ``sq_norm`` (None: ``_global_norm_sq``) gives Σ‖leaf‖² of a
gradient dict where its leaves are blocks of sharded parameters (the GSPMD
path's ``core/sharded.ShardPlan.sq_norm``); only AdaGrad-Norm reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    name: str = ""


def _zeros_like(params):
    return {k: torch.zeros(params[k].shape, dtype=F32,
                           device=params[k].device) for k in sorted(params)}


def apply_updates(params, updates):
    return {k: (params[k].to(F32) - updates[k]).to(params[k].dtype)
            for k in sorted(params)}


def _global_norm_sq(tree) -> torch.Tensor:
    """Σ‖leaf‖², summed over leaves in sorted key order."""
    return sum(torch.sum(torch.square(tree[k].to(F32))) for k in sorted(tree))


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(g, state, params=None, sq_norm=None):
        return {k: lr * g[k].to(F32) for k in sorted(g)}, state

    return Optimizer(init, update, "sgd")


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    """Heavy-ball momentum (server-side)."""

    def init(params):
        return _zeros_like(params)

    def update(g, state, params=None, sq_norm=None):
        m = {k: beta * state[k] + (1 - beta) * g[k].to(F32) for k in sorted(g)}
        return {k: lr * m[k] for k in sorted(m)}, m

    return Optimizer(init, update, "momentum")


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        dev = next(iter(params.values())).device
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(g, state, params=None, sq_norm=None):
        t = state["t"] + 1
        keys = sorted(g)
        m = {k: b1 * state["m"][k] + (1 - b1) * g[k].to(F32) for k in keys}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(g[k].to(F32))
             for k in keys}
        c1 = 1 - b1 ** t.to(F32)
        c2 = 1 - b2 ** t.to(F32)
        upd = {k: lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
               for k in keys}
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adam")


def adagrad_norm(eta0: float) -> Optimizer:
    """AdaGrad-Norm (Eq. 7): single accumulated squared-norm scalar."""

    def init(params):
        dev = next(iter(params.values())).device
        return torch.zeros((), dtype=F32, device=dev)

    def update(g, acc, params=None, sq_norm=None):
        acc = acc + (sq_norm or _global_norm_sq)(g)
        eta = eta0 / torch.sqrt(torch.clamp_min(acc, 1e-12))
        return {k: eta * g[k].to(F32) for k in sorted(g)}, acc

    return Optimizer(init, update, "adagrad_norm")



def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    """The optimizer registered as ``name`` (``sgd``, ``momentum``, ``adam``
    or ``adagrad_norm``) at learning rate ``lr``; ``kw`` its other
    hyperparameters. An unknown name raises ``KeyError``."""
    return {"sgd": sgd, "momentum": momentum, "adam": adam,
            "adagrad_norm": adagrad_norm}[name](lr, **kw)
