"""The classification testbed of the Section-6 experiments: a small tanh MLP
on the synthetic Gaussian-mixture dataset, with a per-unit gradient fn and
the index sampler the training loop expects.

Parameters are ``dict[str, Tensor]`` in the JAX package's names and layouts
(``w1`` (64, 128), ``b1`` (128,), ``w2`` (128, 10), ``b2`` (10,); logits are
``tanh(x @ w1 + b1) @ w2 + b2``), so weights carry across unchanged.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.data.pipeline import gaussian_mixture_dataset
from repro_torch.device import resolve_device

N_CLASSES = 10
DIM = 64
HIDDEN = 128
N_TRAIN = 20000


class ClfMLP(nn.Module):
    """64 → 128 (tanh) → 10, weights stored as ``x @ w`` operands."""

    def __init__(self, device=None):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(DIM, HIDDEN, device=device))
        self.b1 = nn.Parameter(torch.empty(HIDDEN, device=device))
        self.w2 = nn.Parameter(torch.empty(HIDDEN, N_CLASSES, device=device))
        self.b2 = nn.Parameter(torch.empty(N_CLASSES, device=device))

    def forward(self, x):
        h = torch.tanh(x @ self.w1 + self.b1)
        return h @ self.w2 + self.b2


# the module only gives the computation its structure; its parameters come
# in through functional_call, so it holds none of its own
_MLP = ClfMLP(device="meta")


def init_clf(seed: int = 0, device="cuda"):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (not the JAX package's ``init_clf`` draw)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    params = {
        "w1": torch.randn(DIM, HIDDEN, generator=g) * (1 / DIM ** 0.5),
        "b1": torch.zeros(HIDDEN),
        "w2": torch.randn(HIDDEN, N_CLASSES, generator=g) * (1 / HIDDEN ** 0.5),
        "b2": torch.zeros(N_CLASSES),
    }
    return {k: params[k].to(dev) for k in sorted(params)}


def clf_logits(params, x):
    return torch.func.functional_call(_MLP, params, (x,))


def clf_loss(params, batch):
    x, y = batch
    logp = torch.log_softmax(clf_logits(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y[:, None]))


def make_index_sampler(m: int, unit_batch: int = 32, seed: int = 0,
                       n_train: int = N_TRAIN, device="cuda"):
    """``sampler(t, k) -> (m, k, unit_batch)`` int64 training indices in
    [0, n_train) on ``device``, drawn from a CPU ``torch.Generator`` seeded
    per (seed, t), so a round's batch is the same on every device. Not
    stream-equal to the JAX package's threefry sampler: tests hand both
    packages the JAX indices."""
    dev = resolve_device(device)

    def sampler(t, k):
        g = torch.Generator().manual_seed((seed + 17) * 1_000_003 + t)
        idx = torch.randint(0, n_train, (m, k, unit_batch), generator=g)
        return idx.to(dev)

    return sampler


def make_task(m: int, unit_batch: int = 32, seed: int = 0, noise: float = 1.0,
              device="cuda"):
    """Returns (params0, grad_fn, sampler, eval_fn), all on ``device``.

    ``grad_fn(params, idx)`` is the gradient of the mean loss over the unit
    batch ``Xtr[idx]``; ``eval_fn(params, t)`` returns ``{"test_acc": ...}``
    on the 4000 held-out points. ``noise`` is the mixture's noise scale
    (``gaussian_mixture_dataset``)."""
    dev = resolve_device(device)
    X, y = gaussian_mixture_dataset(N_CLASSES, DIM, N_TRAIN + 4000, seed=seed,
                                    noise=noise)
    Xtr = torch.from_numpy(X[:N_TRAIN]).to(dev)
    ytr = torch.from_numpy(y[:N_TRAIN]).long().to(dev)
    Xte = torch.from_numpy(X[N_TRAIN:]).to(dev)
    yte = torch.from_numpy(y[N_TRAIN:]).long().to(dev)

    def grad_fn(params, idx):
        return torch.func.grad(clf_loss)(params, (Xtr[idx], ytr[idx]))

    def eval_fn(params, t):
        with torch.no_grad():
            pred = torch.argmax(clf_logits(params, Xte), dim=-1)
            return {"test_acc": float(torch.mean((pred == yte).float()))}

    sampler = make_index_sampler(m, unit_batch, seed=seed, device=dev)
    return init_clf(seed, dev), grad_fn, sampler, eval_fn
