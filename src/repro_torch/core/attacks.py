"""Byzantine attacks (Appendix J) and the momentum-tailored dynamic attack
(App. E): every attack of the JAX package's ``core/attacks.py``.

Every attack maps a worker-stacked gradient dict (leading worker axis m) and
a boolean Byzantine mask (m,) to the attacked stack. Honest statistics (mean,
std) are computed over the honest workers only: the omniscient variant of
the paper.

Random numbers. The JAX package's attacks take a threefry ``key``; the port
does not reproduce that stream. Every attack here takes an optional
``generator=`` keyword instead, and only ``random`` reads it. The drivers
(``core/robust_train.py``) hold one ``torch.Generator`` on the params'
device, seeded once a run from ``seed * 100_003`` (DynaBRO) or
``seed * 77_003`` (worker momentum), and draw from it in round order: in a
round, one normal draw of each leaf in sorted key order, of the leaf's whole
(n, m, ...) stack of the round's n within-round computations (computation k
before k + 1, worker i before i + 1 within a computation). The per-round
and the compiled drivers draw the same numbers in the same order.

``random`` therefore runs on the whole stack at once (``STACK_ATTACKS``):
it takes a stack of any leading shape (..., m, ...) with a mask (..., m),
where the deterministic attacks take one computation's (m, ...) and are
mapped over the n computations with ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

F32 = torch.float32


def _honest_mean(l: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of the rows of ``l`` (m, ...) that ``mask`` (m,) leaves honest,
    in float32; 0 when every worker is Byzantine."""
    w = (~mask).to(F32)
    w = w / torch.clamp(w.sum(), min=1.0)
    return torch.einsum("i,i...->...", w, l.to(F32))


def _apply(stacked, mask, fn):
    def leaf(l):
        byz = fn(l)
        mk = mask.reshape((-1,) + (1,) * (l.dim() - 1))
        return torch.where(mk, byz.to(l.dtype), l)
    return {k: leaf(stacked[k]) for k in sorted(stacked)}


def none(stacked, mask, generator=None):
    """No attack: every worker sends its honest gradient."""
    return stacked


def sign_flip(stacked, mask, generator=None, scale: float = 1.0):
    """SF (Allen-Zhu et al., 2020): negate own gradient."""
    return _apply(stacked, mask, lambda l: -scale * l.to(F32))


def ipm(stacked, mask, generator=None, eps: float = 0.1):
    """Inner-product manipulation (Xie et al., 2020): send −ε · mean(honest)."""
    return _apply(stacked, mask,
                  lambda l: (-eps * _honest_mean(l, mask)).expand(l.shape))


def alie_auto_z(mask: torch.Tensor) -> torch.Tensor:
    """The Baruch et al. (2019) z_max, from the Byzantine count in ``mask``.

    With m workers of which b are Byzantine, the attacker needs
    ``s = ⌊m/2 + 1⌋ − b`` honest "supporters" closer to the shifted value
    than to the honest mean; the largest undetected shift is
    ``z = Φ⁻¹((m − b − s) / (m − b))``. A float32 tensor computed on the
    mask's device (no host sync)."""
    m = mask.shape[0]
    b = torch.sum(mask.to(F32))
    s = (m // 2 + 1) - b  # ⌊m/2 + 1⌋ in integers
    good = torch.clamp(m - b, min=1.0)
    frac = (good - s) / good
    return torch.special.ndtri(torch.clamp(frac, 1e-6, 1.0 - 1e-6)).to(F32)


def alie(stacked, mask, generator=None, z: Optional[float] = 1.22):
    """A Little Is Enough (Baruch et al., 2019): mean − z·std, element-wise.
    ``z=None`` derives z from (m, n_byz) with ``alie_auto_z``."""
    z_eff = alie_auto_z(mask) if z is None else z

    def leaf(l):
        w = (~mask).to(F32)
        wn = w / torch.clamp(w.sum(), min=1.0)
        wb = wn.reshape((-1,) + (1,) * (l.dim() - 1))
        mu = (l.to(F32) * wb).sum(0)
        var = (torch.square(l.to(F32) - mu) * wb).sum(0)
        return (mu - z_eff * torch.sqrt(var + 1e-12)).expand(l.shape)
    return _apply(stacked, mask, leaf)


def random_noise(stacked, mask, generator=None, scale: float = 10.0):
    """Gaussian garbage: Byzantine rows replaced by ``scale`` times standard
    normal draws from ``generator`` (required), one draw of each leaf's
    whole shape, leaves in sorted key order. ``mask`` may carry leading
    axes: a (..., m) mask over a (..., m, ...) stack."""
    if generator is None:
        raise ValueError("the random attack draws from a torch.Generator: "
                         "pass generator=")

    def leaf(l):
        noise = torch.randn(l.shape, generator=generator, dtype=F32,
                            device=l.device)
        mk = mask.reshape(mask.shape + (1,) * (l.dim() - mask.dim()))
        return torch.where(mk, (scale * noise).to(l.dtype), l)
    return {k: leaf(stacked[k]) for k in sorted(stacked)}


def shift(stacked, mask, generator=None, v: float = 1.0):
    """Constant-shift attack g + v·1 (used by the App. E dynamic attack)."""
    return _apply(stacked, mask, lambda l: l.to(F32) + v)


ATTACKS: Dict[str, Callable] = {
    "none": none,
    "sign_flip": sign_flip,
    "ipm": ipm,
    "alie": alie,
    "random": random_noise,
    "shift": shift,
}

# attacks that draw random numbers: they run on a round's whole stack, outside
# vmap (whose default randomness="error" refuses a draw)
STACK_ATTACKS = frozenset({"random"})


def get_attack(name: str, **kw) -> Callable:
    """``attack(stacked, mask, generator=None)`` for ``name``, with ``kw``
    bound; unknown names raise ``ValueError``."""
    if name not in ATTACKS:
        raise ValueError(f"unknown attack {name!r}; known: "
                         f"{tuple(sorted(ATTACKS))}")
    fn = ATTACKS[name]
    if kw:
        return lambda s, m, generator=None: fn(s, m, generator=generator, **kw)
    return fn


# ----------------------------------------------------- App. E dynamic attack


def momentum_attack_v(t: int, alpha: float, lam: float = 1.0):
    """Attack magnitude v_t of the momentum-tailored dynamic attack (App. E).

    Keeps every worker's momentum biased by ≈ λ despite each worker being
    Byzantine for only 1/(3α) of the time. Returns the scalar multiplier of
    the fixed direction v.
    """
    period = max(int(round(1.0 / alpha)), 3)
    third = max(period // 3, 1)
    tm = t % period
    if t < period:  # first epoch
        if tm in (third, 2 * third):
            return lam / alpha
        return lam
    if tm == 0:  # first round of later epochs (t mod 1/α == 1 in 1-based)
        return lam * (1.0 - (1.0 - alpha) ** (2 * third)) / alpha
    return lam


def momentum_attack_byz_index(t: int, alpha: float, m: int = 3) -> int:
    """Which worker (of 3 groups) is Byzantine at round t under App. E."""
    period = max(int(round(1.0 / alpha)), 3)
    third = max(period // 3, 1)
    return (t % period) // third % 3
