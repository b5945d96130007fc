"""Wrappers of the coordinate-wise reduce kernel, ``csrc/cw_reduce.cu``.

The CUDA counterpart of the reduce stage of the JAX package's Pallas kernel
(``repro/kernels/fused.py::fused_pass`` with ``reduce=`` "med" / "tm" /
"mean", static or traced trim): each column of an (m, d) stack is sorted
across its m rows and reduced to one float32. The source file's header
gives the design and what bounds it.

On a CUDA tensor a wrapper launches the kernel, or raises. On a CPU tensor,
and only there, it computes the plain version in ``kernels/ref.py``. Every
launch adds one to ``LAUNCHES["cw_reduce"]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

REDUCE_MODES = ("med", "tm", "mean")
MAX_ROWS = 64  # the kernel's register-resident sorting network goes to 64
LAUNCHES = {"cw_reduce": 0}

_KERNEL_MODE = {"med": 0, "tm": 0, "mean": 1}
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load_library("cw_reduce")
    lib.cw_reduce_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.cw_reduce_launch.restype = ctypes.c_int
    lib.cw_reduce_error_string.argtypes = [ctypes.c_int]
    lib.cw_reduce_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, mode: str, trim: int) -> torch.Tensor:
    m, d = x.shape
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.cw_reduce_launch(
            x.data_ptr(), out.data_ptr(), m, d, int(x.dtype == torch.bfloat16),
            _KERNEL_MODE[mode], trim, stream)
    if err:
        raise RuntimeError(f"cw_reduce launch failed: "
                           f"{lib.cw_reduce_error_string(err).decode()}")
    LAUNCHES["cw_reduce"] += 1
    return out


def cw_reduce(x: torch.Tensor, mode: str, trim: int = 0) -> torch.Tensor:
    """x: (m, d) float32 or bfloat16, contiguous, 1 <= m <= 64 -> (d,) float32.

    ``mode``: "med" (median; the mean of the two middle rows for even m),
    "tm" (trimmed mean dropping ``trim`` rows at each end, ``trim`` clipped
    to [0, (m-1)//2]) or "mean"."""
    if mode not in REDUCE_MODES:
        raise ValueError(f"unknown reduce mode {mode!r}; want one of "
                         f"{REDUCE_MODES}")
    if x.dim() != 2:
        raise ValueError(f"cw_reduce takes an (m, d) matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"cw_reduce takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("cw_reduce takes a contiguous (m, d) matrix")
    m, d = x.shape
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"cw_reduce takes 1 to {MAX_ROWS} rows, got {m}")
    trim = (m - 1) // 2 if mode == "med" else min(max(int(trim), 0),
                                                  (m - 1) // 2)
    if x.device.type == "cpu":
        if mode == "med":
            return kref.cwmed_ref(x)
        if mode == "tm":
            return kref.cwtm_ref(x, trim)
        return kref.cw_mean_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"cw_reduce runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if d == 0:
        return torch.empty(0, dtype=torch.float32, device=x.device)
    return _launch(x, mode, trim)


def cwmed(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median. x: (m, d) -> (d,) float32."""
    return cw_reduce(x, "med")


def cwtm(x: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean with an int trim. x: (m, d) -> (d,)."""
    return cw_reduce(x, "tm", int(trim))


def cwtm_masked(x: torch.Tensor, trim: torch.Tensor) -> torch.Tensor:
    """Trimmed mean with the trim count as an integer tensor (the JAX
    package's traced-trim form). The kernel takes the count as a launch
    argument, so a trim that lives on the card is read back first."""
    return cw_reduce(x, "tm", int(trim))
