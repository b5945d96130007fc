"""Datasets and the classification task."""
from repro_torch.data.classification import ClfMLP, make_index_sampler, make_task
from repro_torch.data.pipeline import gaussian_mixture_dataset

__all__ = ["ClfMLP", "make_index_sampler", "make_task",
           "gaussian_mixture_dataset"]
