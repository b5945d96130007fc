"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), keyed by a
hash of every source under ``csrc/`` and the flags, under ``build/repro_torch/``
at the root of the checkout. Nothing builds at import time: the CPU tests
import every module, and a CPU-only machine has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --split-compile=0: nvcc optimizes a source's kernels on every core (half
# the build's wall time on the H100's host; the same registers and spills)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")
# the libraries this process built with nvcc (one a source): with the level
# graphs' ``core.robust_train.CAPTURES``, the compiles that
# ``lint.runtime.recompile_guard`` counts
BUILDS = {"builds": 0}
_BUILDS_LOCK = threading.Lock()


def build_count() -> int:
    with _BUILDS_LOCK:
        return BUILDS["builds"]


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under the toolkit PyTorch
    finds (``CUDA_HOME``). Raises when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are compiled at "
            "first use and need the CUDA toolkit (nvcc on PATH or CUDA_HOME)")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}_{_digest()}.so"


def build(names: Sequence[str]) -> float:
    """Compile every ``csrc/<name>.cu`` not built yet, one ``nvcc`` each, all
    started together. Writes the compiler's register/spill report beside each
    library as ``<library>.log``. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        with _BUILDS_LOCK:
            BUILDS["builds"] += 1
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if needed.
    Callers keep the handle (``kernels/fused.py`` caches it)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def build_log(name: str) -> str:
    """The compiler's report (registers, spills) of the built library."""
    path = library_path(name)
    return path.with_name(path.name + ".log").read_text()
