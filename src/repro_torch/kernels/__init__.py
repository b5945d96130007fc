"""Hand-written CUDA kernels and their plain PyTorch versions."""
from repro_torch.kernels.fused import (
    LAUNCHES, cw_reduce, cwmed, cwtm, cwtm_masked,
)
from repro_torch.kernels.ref import cw_mean_ref, cwmed_ref, cwtm_ref

__all__ = ["LAUNCHES", "cw_reduce", "cwmed", "cwtm", "cwtm_masked",
           "cw_mean_ref", "cwmed_ref", "cwtm_ref"]
