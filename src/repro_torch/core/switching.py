"""Identity-switching strategies (Section 6).

Host-side, seeded, reproducible. Each strategy yields a boolean mask (m,)
per round: True = Byzantine. ``within_round(t, k)`` supports the dynamic-round
model of Section 4 where identities may flip between the k-th gradient
computations of one round (data poisoning); the default strategies only switch
*between* rounds (τ_d = ∅ w.r.t. within-round changes).

A copy of the JAX package's ``core/switching.py`` (plain numpy), kept here so
that this package imports nothing of that one; the two must give equal masks.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.agg_engine import count_floor


class Switcher:
    def __init__(self, m: int, seed: int = 0):
        self.m = m
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def mask(self, t: int) -> np.ndarray:
        raise NotImplementedError

    def within_round(self, t: int, k: int) -> np.ndarray:
        """Mask at the k-th gradient computation of round t (default: static)."""
        return self.mask(t)

    def mask_schedule(self, T: int, n_max: int = 1) -> np.ndarray:
        """Full identity schedule as a (T, n_max, m) bool tensor with entry
        ``[t, k] == within_round(t, k)`` — the device-side input of the
        compiled ``lax.scan`` driver (DESIGN.md §5). ``within_round`` is
        assumed to be a pure function of (t, k); strategies whose masks carry
        hidden per-call state must keep it in ``mask`` (as ``Bernoulli``
        does, idempotently), or the schedule cannot be precomputed.

        Strategies that only switch *between* rounds supply a vectorized
        (T, m) fast path via ``_mask_schedule_rounds``; it is broadcast over
        the within-round axis. The fast path is bypassed when it cannot be
        trusted for this instance: when ``within_round`` is overridden, or
        when ``mask`` is overridden below the class that provided the fast
        path (the parent's vectorization knows nothing of the new masks)."""
        if T <= 0:
            return np.zeros((0, n_max, self.m), bool)
        cls = type(self)

        def defining(name):
            for c in cls.__mro__:
                if name in c.__dict__:
                    return c
            return Switcher

        if (cls.within_round is Switcher.within_round
                and issubclass(defining("_mask_schedule_rounds"),
                               defining("mask"))):
            rounds = self._mask_schedule_rounds(T)
            if rounds is not None:
                return np.broadcast_to(rounds[:, None, :],
                                       (T, n_max, self.m)).copy()
        out = np.empty((T, n_max, self.m), bool)
        for t in range(T):
            for k in range(n_max):
                out[t, k] = self.within_round(t, k)
        return out

    def _mask_schedule_rounds(self, T: int):
        """Vectorized (T, m) between-round schedule, or None for the generic
        per-(t, k) loop."""
        return None

    def switch_rounds(self, T: int) -> int:
        """|rounds with a different mask than the previous round| (≈ |τ_d|
        in the between-round sense used by the experiments)."""
        n, prev = 0, None
        for t in range(T):
            cur = tuple(self.mask(t))
            if prev is not None and cur != prev:
                n += 1
            prev = cur
        return n


class Static(Switcher):
    """Fixed Byzantine set (the classical setting)."""

    def __init__(self, m: int, n_byz: int, seed: int = 0):
        super().__init__(m, seed)
        self._mask = np.zeros(m, bool)
        idx = self.rng.choice(m, n_byz, replace=False)
        self._mask[idx] = True

    def mask(self, t):
        return self._mask

    def _mask_schedule_rounds(self, T):
        return np.broadcast_to(self._mask, (T, self.m))


class Periodic(Switcher):
    """Periodic(K): resample the δm Byzantine workers every K rounds."""

    def __init__(self, m: int, n_byz: int, K: int, seed: int = 0):
        super().__init__(m, seed)
        self.n_byz = n_byz
        self.K = K
        self._cache = {}

    def mask(self, t):
        e = t // self.K
        if e not in self._cache:
            rng = np.random.default_rng(self.seed * 1_000_003 + e)
            mask = np.zeros(self.m, bool)
            mask[rng.choice(self.m, self.n_byz, replace=False)] = True
            self._cache[e] = mask
        return self._cache[e]

    def _mask_schedule_rounds(self, T):
        epochs = np.arange(T) // self.K
        per_epoch = np.stack([self.mask(e * self.K) for e in range(epochs[-1] + 1)])
        return per_epoch[epochs]


class Bernoulli(Switcher):
    """Bernoulli(p, D, δmax): each worker independently turns Byzantine with
    prob p per round, for a fixed duration of D rounds, capped at δmax·m
    simultaneous Byzantine workers."""

    def __init__(self, m: int, p: float, D: int, delta_max: float, seed: int = 0):
        super().__init__(m, seed)
        self.p = p
        self.D = D
        # nudged floor: a bare int() truncation of the f64 product caps one
        # worker short at exact boundaries (int(0.3 * 10) == 2, exact is 3)
        self.cap = count_floor(delta_max * m)
        self._until = np.zeros(m, np.int64)  # byz until round (exclusive)
        self._computed_to = 0

    def _advance(self, t):
        while self._computed_to <= t:
            s = self._computed_to
            active = (self._until > s).sum()
            draws = self.rng.random(self.m) < self.p
            for i in np.nonzero(draws)[0]:
                if self._until[i] <= s and active < self.cap:
                    self._until[i] = s + self.D
                    active += 1
            self._computed_to += 1

    def mask(self, t):
        self._advance(t)
        return self._until > t

    def _mask_schedule_rounds(self, T):
        # inherently sequential (each round's draws depend on who is already
        # infected), but one row per round — the n_max axis is broadcast
        return np.stack([self.mask(t) for t in range(T)])


class MomentumTailored(Switcher):
    """Appendix E: rotate the single Byzantine worker among 3 groups, once per
    1/(3α) rounds — defeats worker-momentum with only O(√T) switches."""

    def __init__(self, m: int, alpha: float, seed: int = 0):
        super().__init__(m, seed)
        self.alpha = alpha
        self.period = max(int(round(1.0 / alpha)), 3)
        self.third = max(self.period // 3, 1)

    def mask(self, t):
        g = (t % self.period) // self.third % 3
        mask = np.zeros(self.m, bool)
        # group g of 3 equal groups is Byzantine
        lo = g * self.m // 3
        hi = (g + 1) * self.m // 3
        mask[lo:hi] = True
        return mask

    def _mask_schedule_rounds(self, T):
        g = (np.arange(T) % self.period) // self.third % 3  # (T,) group index
        ranks = np.arange(self.m)
        lo, hi = g * self.m // 3, (g + 1) * self.m // 3
        return (ranks[None, :] >= lo[:, None]) & (ranks[None, :] < hi[:, None])


def get_switcher(name: str, m: int, seed: int = 0, **kw) -> Switcher:
    return {
        "static": Static,
        "periodic": Periodic,
        "bernoulli": Bernoulli,
        "momentum_tailored": MomentumTailored,
    }[name](m, seed=seed, **kw)
