"""Backend-dispatching aggregation engine: the coordinate-wise part of the
JAX package's ``core/agg_engine.py``.

A coordinate-wise rule reduces an (m, d) stack to (d,) per leaf. Each
primitive has two backends: ``ref`` (plain PyTorch, ``kernels/ref.py``) and
``kernel`` (the hand-written CUDA kernel, ``kernels/fused.py``). ``auto``
takes the kernel for a tensor on the card and the plain version for one on
the CPU; ``kernel`` on a CPU tensor raises. There is no size threshold yet:
the JAX package's ``PALLAS_MIN_BYTES`` was set for a TPU and a CPU, and the
H100's is to be set from the kernel and plain times in PERF.md.

Rules stream leaf by leaf in sorted key order; none materializes the flat
(m, d_total) matrix.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from repro_torch.kernels import fused as kfused
from repro_torch.kernels import ref as kref

Tree = Dict[str, torch.Tensor]

BACKENDS = ("ref", "kernel")


def resolve_backend(backend: str, device: torch.device) -> str:
    """The backend a primitive runs for tensors on ``device``."""
    if backend == "auto":
        return "kernel" if device.type == "cuda" else "ref"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS + ('auto',)}")
    if backend == "kernel" and device.type != "cuda":
        raise ValueError(f"backend='kernel' needs CUDA tensors, got {device};"
                         f" use backend='ref' or 'auto' on the CPU")
    return backend


def dispatch_backend(backend: str, x: torch.Tensor) -> str:
    """Per-call backend choice for one primitive on ``x`` (where an H100
    size threshold for ``auto`` will go)."""
    return resolve_backend(backend, x.device)


# ============================================================ primitives
#
# All take x: (m, d) and return (d,) float32.


def cw_mean(x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """(m, d) -> (d,) mean."""
    if dispatch_backend(backend, x) == "kernel":
        return kfused.cw_reduce(x, "mean")
    return kref.cw_mean_ref(x)


def cw_median(x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """(m, d) -> (d,) coordinate-wise median."""
    if dispatch_backend(backend, x) == "kernel":
        return kfused.cwmed(x)
    return kref.cwmed_ref(x)


def cw_trimmed_mean(x: torch.Tensor, trim, *,
                    backend: str = "auto") -> torch.Tensor:
    """(m, d) -> (d,) mean after dropping ``trim`` lowest/highest per
    coordinate. ``trim`` is an int or an integer tensor."""
    if dispatch_backend(backend, x) == "kernel":
        if isinstance(trim, torch.Tensor):
            return kfused.cwtm_masked(x, trim)
        return kfused.cwtm(x, int(trim))
    return kref.cwtm_ref(x, trim)


def _as_mat(l: torch.Tensor) -> torch.Tensor:
    """A worker-stacked leaf (m, ...) as a contiguous (m, d) float32 matrix."""
    return l.reshape(l.shape[0], -1).to(torch.float32).contiguous()


# ============================================================ rule bases


class Aggregator:
    """Base: ``.tree()`` aggregates a worker-stacked parameter dict (every
    leaf with a leading worker axis m) into one worker's shape."""

    name = "base"

    def __init__(self, backend: str = "auto"):
        self.backend = backend

    def tree(self, stacked: Tree) -> Tree:
        raise NotImplementedError


class CoordinateWiseRule(Aggregator):
    """Rules that reduce each coordinate independently (Mean / CWMed / CWTM)."""

    def _reduce(self, mat: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def leaf(self, l: torch.Tensor) -> torch.Tensor:
        out = self._reduce(_as_mat(l))
        return out.reshape(l.shape[1:]).to(l.dtype)

    def tree(self, stacked: Tree) -> Tree:
        return {k: self.leaf(stacked[k]) for k in sorted(stacked)}


# ============================================================ registry

_REGISTRY: Dict[str, Callable[..., Aggregator]] = {}
_NOT_PORTED = ("krum", "geomed", "mfm", "nnm")


def register(name: str, factory: Callable[..., Aggregator]) -> None:
    _REGISTRY[name] = factory


def get_aggregator(name: str, delta: float = 0.25,
                   backend: str = "auto") -> Aggregator:
    """The rule registered as ``name``. Rules of the JAX package that this
    package has not ported yet raise ``NotImplementedError``."""
    import repro_torch.core.aggregators  # noqa: F401  (registers the rules)
    name = name.lower()
    if name not in _REGISTRY:
        if name.split("+")[0] in _NOT_PORTED:
            raise NotImplementedError(
                f"aggregator {name!r} is not yet ported to repro_torch; "
                f"ported: {tuple(sorted(_REGISTRY))}")
        raise ValueError(f"unknown aggregator {name!r}; known: "
                         f"{tuple(sorted(_REGISTRY))}")
    return _REGISTRY[name](delta=delta, backend=backend)


def count_ceil(v: float) -> int:
    """⌈v⌉ for host-side δ·m counts, nudged by 1e-5: 0.28·25 is exactly 7,
    but f64 rounds the product to 7.000000000000001."""
    # jaxlint: disable=JXL003 -- this IS the sanctioned nudged helper JXL003 points at
    return math.ceil(v - 1e-5)


def count_floor(v: float) -> int:
    """⌊v⌋ for host-side δ·m counts, nudged by 1e-5 the other way: 0.3·10
    is exactly 3, but f64 rounds the product to 2.9999999999999996."""
    # jaxlint: disable=JXL003 -- this IS the sanctioned nudged helper JXL003 points at
    return math.floor(v + 1e-5)


def trim_count(delta: float, m: int) -> int:
    """⌈δm⌉ clipped to keep at least one row after two-sided trimming."""
    return min(count_ceil(delta * m), (m - 1) // 2)
