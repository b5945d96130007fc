"""Byzantine attacks (Appendix J): the ones this package has ported so far.

Every attack maps a worker-stacked gradient dict (leading worker axis m) and
a boolean Byzantine mask (m,) to the attacked stack.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

_NOT_PORTED = ("ipm", "alie", "random", "shift")


def _apply(stacked, mask, fn):
    def leaf(l):
        byz = fn(l)
        mk = mask.reshape((-1,) + (1,) * (l.dim() - 1))
        return torch.where(mk, byz.to(l.dtype), l)
    return {k: leaf(stacked[k]) for k in sorted(stacked)}


def none(stacked, mask):
    """No attack: every worker sends its honest gradient."""
    return stacked


def sign_flip(stacked, mask, scale: float = 1.0):
    """SF (Allen-Zhu et al., 2020): negate own gradient."""
    return _apply(stacked, mask, lambda l: -scale * l.to(torch.float32))


ATTACKS: Dict[str, Callable] = {
    "none": none,
    "sign_flip": sign_flip,
}


def get_attack(name: str, **kw) -> Callable:
    """``attack(stacked, mask)`` for ``name``, with ``kw`` bound."""
    if name not in ATTACKS:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"attack {name!r} is not yet ported to repro_torch; ported: "
                f"{tuple(sorted(ATTACKS))}")
        raise ValueError(f"unknown attack {name!r}; known: "
                         f"{tuple(sorted(ATTACKS))}")
    fn = ATTACKS[name]
    if kw:
        return lambda s, m: fn(s, m, **kw)
    return fn
