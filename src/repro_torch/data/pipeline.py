"""Synthetic datasets.

* ``SyntheticLMData``: language-model token streams with a learnable
  structure (squared-uniform marginals and a 0.3 copy of the previous
  token), the port of the JAX package's ``data/pipeline.SyntheticLMData``.
  Each draw comes from its own ``torch.Generator`` keyed on (seed, step),
  (seed, step, worker) or (seed, step, worker, k), so a unit batch is a pure
  function of its key and the level-(j−1) MLMC batch is the prefix of the
  level-j one. The stream is the port's own: the JAX package draws from
  threefry keys, and tests hand both packages the same numpy tokens.
* ``gaussian_mixture_dataset``: the classification task's data (plain
  numpy, copied from the JAX package so that both packages draw
  bitwise-equal data).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

COPY_P = 0.3  # the share of positions that repeat the previous base token


def key_seed(*key: int) -> int:
    """A 64-bit seed from the key's hash (``np.random.SeedSequence``), so
    that keys of different lengths or entries give unrelated streams."""
    entropy = [int(k) % 2 ** 64 for k in key]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def _generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from ``key_seed(*key)``."""
    return torch.Generator().manual_seed(key_seed(*key))


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: Any = "cuda"

    def _tokens(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """(batch, seq_len) int64 tokens on the CPU: a squared-uniform base
        token a position, and with probability 0.3 the previous position's
        base token instead (the rolled base, the first position taking the
        last's)."""
        u = torch.rand((batch, self.seq_len), generator=gen)
        base = (u * u * self.vocab_size).to(torch.int64)
        copy = torch.rand((batch, self.seq_len), generator=gen) < COPY_P
        rolled = torch.roll(base, 1, dims=1)
        return torch.where(copy, rolled, base) % self.vocab_size

    def _out(self, toks: torch.Tensor, seq_axis: int) -> Dict[str, torch.Tensor]:
        toks = toks.to(resolve_device(self.device))
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=seq_axis)}

    def batch(self, step: int, batch: int | None = None) -> dict:
        """The (batch, S) tokens and next-token labels of ``step`` (default
        ``global_batch``), keyed on (seed, step)."""
        # `batch or global_batch` would silently promote an explicit 0
        if batch is None:
            batch = self.global_batch
        if batch <= 0:
            raise ValueError(f"batch must be positive, got {batch}")
        return self._out(self._tokens(_generator(self.seed, step), batch), 1)

    def worker_batch(self, step: int, worker: int, batch: int) -> dict:
        """Worker ``worker``'s (batch, S) batch of ``step``, keyed on (seed,
        step, worker)."""
        return self._out(
            self._tokens(_generator(self.seed, step, worker), batch), 1)

    def mlmc_batches(self, step, m: int, n: int, unit_batch: int) -> dict:
        """(m, n, unit_batch, S) token/label tensors for one DynaBRO round.

        Unit (w, k) is keyed on (seed, step, w, k), a pure function of the
        round, the worker and the within-round index, so the level-(j−1)
        mini-batch is the prefix of the level-j one (the MLMC nesting)."""
        if unit_batch <= 0:
            raise ValueError(f"unit_batch must be positive, got {unit_batch}")
        toks = torch.stack([
            torch.stack([self._tokens(_generator(self.seed, step, w, k),
                                      unit_batch) for k in range(n)])
            for w in range(m)])
        return self._out(toks, 3)

    def mlmc_sampler(self, m: int, unit_batch: int = 1):
        """``sample_batches(t, n)`` closure for the DynaBRO drivers."""
        return lambda t, n: self.mlmc_batches(t, m, n, unit_batch)


def gaussian_mixture_dataset(n_classes: int, dim: int, n: int, seed: int = 0,
                             noise: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed class means on a sphere, isotropic noise. Returns (X, y)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n_classes, dim))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    means *= 3.0
    y = rng.integers(0, n_classes, size=n)
    X = means[y] + noise * rng.normal(size=(n, dim))
    return X.astype(np.float32), y.astype(np.int32)
