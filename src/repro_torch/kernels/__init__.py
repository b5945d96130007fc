"""Hand-written CUDA kernels and their plain PyTorch versions."""
from repro_torch.kernels.fused import (
    LAUNCHES, combine_reduce, cross_sqdist, cw_reduce, cwmed, cwtm,
    cwtm_masked, fused_pass, pairwise_sqdist, tree_combine_reduce,
    tree_cw_reduce, tree_weighted_combine, weighted_combine,
)
from repro_torch.kernels.ref import (
    combine_reduce_ref, cross_sqdist_ref, cw_mean_ref, cw_reduce_ref,
    cwmed_ref, cwtm_ref, pairwise_sqdist_ref, weighted_combine_ref,
)

__all__ = ["LAUNCHES", "combine_reduce", "cross_sqdist", "cw_reduce", "cwmed",
           "cwtm", "cwtm_masked", "fused_pass", "pairwise_sqdist",
           "tree_combine_reduce", "tree_cw_reduce", "tree_weighted_combine",
           "weighted_combine", "combine_reduce_ref", "cross_sqdist_ref",
           "cw_mean_ref", "cw_reduce_ref", "cwmed_ref", "cwtm_ref",
           "pairwise_sqdist_ref", "weighted_combine_ref"]
