"""Runtime sanitizers: the recompile guard and the NaN/Inf tripwire.

Static analysis catches hazards visible in source; these catch the two
that show only at run time: compiling again in a steady state (a capture
that costs tenths of a second where a replay costs microseconds) and
non-finite values passing through a robust rule that is meant to bound
them.

What the port compiles: a CUDA graph of an MLMC level, captured by the
compiled driver (``core.robust_train._LevelGraphs.capture``, one for each
level key, however many pieces a worker mesh cuts it into;
``robust_train.CAPTURES``), and a kernel library built by ``nvcc``
(``kernels.build.build``, one for each source; ``build.BUILDS``). Both
counters are process-global and kept behind a lock, so a capture on any
thread inside a guarded window counts (the aggregation service captures
on its serve thread). On the CPU rounds run eagerly, so nothing is
captured or built and a guard counts 0, as the JAX package's counts 0 on
a warm jit cache.

torch is imported lazily, so ``repro_torch.lint``'s static side stays
importable where torch is not installed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Optional


class RecompileError(AssertionError):
    """A guarded steady-state region compiled."""


def install_compile_counter() -> None:
    """The counters are always on; this imports the modules that keep them
    (the JAX package's hook into ``jax.monitoring`` has nothing to hook
    here). Idempotent."""
    from repro_torch.core import robust_train  # noqa: F401
    from repro_torch.kernels import build  # noqa: F401


def compile_count() -> int:
    """Level-graph captures plus ``nvcc`` builds made by this process."""
    from repro_torch.core.robust_train import capture_count
    from repro_torch.kernels.build import build_count

    return capture_count() + build_count()


@dataclasses.dataclass
class GuardStats:
    """Filled in when the guarded block exits: ``count`` is the number of
    compiles (captures and builds) made inside the window."""

    label: str
    count: int = 0


@contextlib.contextmanager
def recompile_guard(label: str = "steady state", max_recompiles: int = 0,
                    action: str = "raise") -> Iterator[GuardStats]:
    """Assert a warmed code region replays what it has captured.

    ``action="raise"`` raises ``RecompileError`` when more than
    ``max_recompiles`` compiles land inside the block (the default, and the
    contract ``Session`` enforces in guarded mode); ``action="count"`` only
    records the delta in the yielded ``GuardStats``. The count is recorded
    even when the block raises; the guard's own error is suppressed then
    (never mask the original failure).
    """
    if action not in ("raise", "count"):
        raise ValueError(f"unknown action {action!r}; expected raise|count")
    install_compile_counter()
    stats = GuardStats(label)
    start = compile_count()
    try:
        yield stats
    except BaseException:
        stats.count = compile_count() - start
        raise
    stats.count = compile_count() - start
    if action == "raise" and stats.count > max_recompiles:
        raise RecompileError(
            f"{label}: {stats.count} recompile(s) in a steady-state region "
            f"(allowed {max_recompiles}): a shape, dtype or level is "
            f"changing between calls, or the graphs were dropped")


# ------------------------------------------------------------ NaN tripwire

TRIPWIRE_ENV = "REPRO_NAN_TRIPWIRE"


def assert_all_finite(tree, label: str = "aggregate") -> None:
    """Host-side NaN/Inf tripwire over a pytree of tensors (or arrays);
    raises ``FloatingPointError`` naming the first offending leaf's path.
    Integer and boolean leaves are exempt."""
    import numpy as np
    import torch
    from torch.utils._pytree import keystr, tree_flatten_with_path

    for path, leaf in tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            finite = torch.isfinite(leaf)
            if bool(finite.all()):
                continue
            bad = int((~finite).sum())
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind not in "fc" or np.isfinite(arr).all():
                continue
            bad = int((~np.isfinite(arr)).sum())
        raise FloatingPointError(
            f"{label}: {bad} non-finite value(s) at leaf "
            f"{keystr(path) or '<root>'}")


def tripwire_enabled(explicit: Optional[bool] = None) -> bool:
    """The tripwire's opt-in: an explicit flag wins, else the
    ``REPRO_NAN_TRIPWIRE`` env var ('1'/'true'/'on')."""
    if explicit is not None:
        return explicit
    return os.environ.get(TRIPWIRE_ENV, "").lower() in ("1", "true", "on")


def maybe_assert_finite(tree, label: str = "aggregate",
                        enabled: Optional[bool] = None) -> None:
    if tripwire_enabled(enabled):
        assert_all_finite(tree, label)
