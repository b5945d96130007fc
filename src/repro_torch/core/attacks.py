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

The theta forms at the bottom (``ATTACK_PARAMS``, ``attack_theta``,
``uniform_attack``, ``attack_switch``) carry an attack's parameters as a
float32 row, so the lanes of a sweep may differ in attack and parameters:
``attack_switch`` runs each distinct attack on its own lanes, one lane at
a time, with their rows as tensors. In a round ``random`` draws its noise once from the
run's generator, as a lone run does, and every ``random`` lane scales the
same draw by its own ``scale``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

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
    ``z=None`` (NaN in a theta row's tensor) derives z from (m, n_byz) with
    ``alie_auto_z``."""
    if isinstance(z, torch.Tensor):
        z_eff = torch.where(torch.isnan(z), alie_auto_z(mask), z)
    else:
        z_eff = alie_auto_z(mask) if z is None else z

    def leaf(l):
        w = (~mask).to(F32)
        wn = w / torch.clamp(w.sum(), min=1.0)
        wb = wn.reshape((-1,) + (1,) * (l.dim() - 1))
        mu = (l.to(F32) * wb).sum(0)
        var = (torch.square(l.to(F32) - mu) * wb).sum(0)
        return (mu - z_eff * torch.sqrt(var + 1e-12)).expand(l.shape)
    return _apply(stacked, mask, leaf)


def draw_noise(stacked, generator) -> Dict[str, torch.Tensor]:
    """The ``random`` attack's draw for ``stacked``: one standard normal
    float32 draw of each leaf's whole shape from ``generator`` (required),
    leaves in sorted key order."""
    if generator is None:
        raise ValueError("the random attack draws from a torch.Generator: "
                         "pass generator=")
    return {k: torch.randn(stacked[k].shape, generator=generator, dtype=F32,
                           device=stacked[k].device) for k in sorted(stacked)}


def apply_noise(stacked, mask, noise, scale):
    """Byzantine rows of ``stacked`` replaced by ``scale`` times ``noise``
    (``draw_noise``'s); ``mask`` may carry leading axes: a (..., m) mask over
    a (..., m, ...) stack."""
    def leaf(l, z):
        mk = mask.reshape(mask.shape + (1,) * (l.dim() - mask.dim()))
        return torch.where(mk, (scale * z).to(l.dtype), l)
    return {k: leaf(stacked[k], noise[k]) for k in sorted(stacked)}


def random_noise(stacked, mask, generator=None, scale: float = 10.0):
    """Gaussian garbage: Byzantine rows replaced by ``scale`` times standard
    normal draws from ``generator`` (required), one draw of each leaf's
    whole shape, leaves in sorted key order. ``mask`` may carry leading
    axes: a (..., m) mask over a (..., m, ...) stack."""
    return apply_noise(stacked, mask, draw_noise(stacked, generator), scale)


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


# ----------------------------------------------- theta forms (sweep lanes)
#
# Slot i of a lane's theta row holds the i-th parameter of its attack per
# ``ATTACK_PARAMS`` (NaN in alie's z slot encodes ``z=None``); the rows are
# float32 tensors on the card, so a sweep's lanes may differ in parameters
# without another graph.

ATTACK_PARAMS: Dict[str, Tuple[Tuple[str, float], ...]] = {
    "none": (),
    "sign_flip": (("scale", 1.0),),
    "ipm": (("eps", 0.1),),
    "alie": (("z", 1.22),),
    "random": (("scale", 10.0),),
    "shift": (("v", 1.0),),
}
N_PARAMS = max(len(spec) for spec in ATTACK_PARAMS.values())

# parameters that accept None (NaN in theta, read by the attack); None for
# any other parameter raises
NAN_SENTINEL_PARAMS = {("alie", "z")}


def attack_theta(name: str,
                 kwargs: Optional[Mapping[str, Any]] = None) -> np.ndarray:
    """(N_PARAMS,) float32 parameter row for ``name``: unset parameters take
    their ``ATTACK_PARAMS`` defaults; unknown ones raise, as does ``None``
    for a parameter without NaN-sentinel support."""
    kw = dict(kwargs or {})
    theta = np.zeros(N_PARAMS, np.float32)
    for i, (pname, default) in enumerate(ATTACK_PARAMS[name]):
        val = kw.pop(pname, default)
        if val is None and (name, pname) not in NAN_SENTINEL_PARAMS:
            raise TypeError(
                f"{name!r} attack parameter {pname!r} does not accept None")
        theta[i] = np.nan if val is None else float(val)
    if kw:
        raise TypeError(f"unknown {name!r} attack parameter(s): {sorted(kw)}")
    return theta


def uniform_attack(name: str) -> Callable:
    """``name`` under the uniform ``(stacked, mask, generator, theta)``
    signature, reading its parameters from the slots of ``theta`` (a
    float32 tensor row)."""
    fn = ATTACKS[name]
    spec = ATTACK_PARAMS[name]

    def call(stacked, mask, generator, theta):
        kw = {pname: theta[i] for i, (pname, _) in enumerate(spec)}
        return fn(stacked, mask, generator=generator, **kw)

    return call


def _lane_rows(tree, idx):
    """The lanes ``idx`` of a dict of (C, ...) leaves, in that order: the
    leaves themselves for every lane in order, else one copy."""
    first = next(iter(tree.values()))
    if list(idx) == list(range(first.shape[0])):
        return tree
    return {k: torch.stack([v[c] for c in idx]) for k, v in tree.items()}


def attack_switch(names: Sequence[str]) -> Callable:
    """``apply(ids, stacked, masks, generator, theta)`` over lanes: ``ids``
    (C host ints) index ``names``; ``stacked`` is a dict of (C, n, m, ...)
    leaves (each lane's n within-round stacks), ``masks`` (C, n, m) bool and
    ``theta`` (C, N_PARAMS) float32 on the leaves' device. Each distinct
    attack runs on its own lanes with their theta rows, one lane at a time
    (a ``vmap`` over the lane's n computations); nothing runs every attack and selects. A lane's
    bits do not depend on the lanes beside it: batched over lanes, ipm's
    honest mean becomes a batched product whose cuBLAS kernel, and so its
    sums, change with the lane count. ``random`` draws one noise stack a
    round from ``generator``, the draw a lone run makes, and each of its
    lanes scales it by its own ``scale`` (element-wise, under ``vmap``).
    Returns the attacked leaves in lane order."""
    names = tuple(names)
    for name in names:
        if name not in ATTACK_PARAMS:
            raise ValueError(f"unknown attack {name!r}; known: "
                             f"{tuple(sorted(ATTACK_PARAMS))}")
    forms = {name: uniform_attack(name) for name in names}

    def run(name, sub, mk, th, generator):
        if name == "none":
            return sub
        if name == "random":
            one = {k: v[0] for k, v in sub.items()}
            noise = draw_noise(one, generator)
            return vmap(lambda s, m, t: apply_noise(s, m, noise, t[0]))(
                sub, mk, th)
        per_unit = vmap(forms[name], in_dims=(0, 0, None, None))
        lanes = [per_unit({k: v[c] for k, v in sub.items()}, mk[c], generator,
                          th[c]) for c in range(mk.shape[0])]
        return {k: torch.stack([lane[k] for lane in lanes]) for k in sorted(sub)}

    def apply(ids, stacked, masks, generator, theta):
        ids = [int(i) for i in ids]
        groups = {}
        for c, i in enumerate(ids):
            groups.setdefault(names[i], []).append(c)
        if len(groups) == 1:
            (name,) = groups
            return run(name, stacked, masks, theta, generator)
        out = {}
        lanes = [None] * len(ids)
        for name, idx in groups.items():
            sub = run(name, _lane_rows(stacked, idx),
                      torch.stack([masks[c] for c in idx]),
                      torch.stack([theta[c] for c in idx]), generator)
            for j, c in enumerate(idx):
                lanes[c] = {k: v[j] for k, v in sub.items()}
        for k in sorted(stacked):
            out[k] = torch.stack([lane[k] for lane in lanes])
        return out

    return apply


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
