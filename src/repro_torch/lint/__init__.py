"""repro_torch.lint: the port's static analysis and runtime sanitizers, the
counterpart of the JAX package's ``repro.lint``.

Two halves, one import surface:

* the static pass (``engine`` / ``rules`` / ``python -m repro_torch.lint``):
  stdlib only, importable without torch;
* the runtime sanitizers (``runtime``): ``recompile_guard``, the compile
  counter (level-graph captures and ``nvcc`` builds) and the NaN/Inf
  tripwire; they need torch and are re-exported lazily, so importing
  ``repro_torch.lint`` never pulls it in.
"""
from __future__ import annotations

from repro_torch.lint.engine import Violation, lint_paths, lint_source  # noqa: F401

_RUNTIME = (
    "GuardStats",
    "RecompileError",
    "assert_all_finite",
    "compile_count",
    "install_compile_counter",
    "maybe_assert_finite",
    "recompile_guard",
    "tripwire_enabled",
)

__all__ = ["Violation", "lint_paths", "lint_source", *_RUNTIME]


def __getattr__(name: str):
    if name in _RUNTIME:
        from repro_torch.lint import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module 'repro_torch.lint' has no attribute {name!r}")
