"""Datasets (the classification task's, the synthetic LM stream) and the
classification task."""
from repro_torch.data.classification import ClfMLP, make_index_sampler, make_task
from repro_torch.data.pipeline import (
    SyntheticLMData, gaussian_mixture_dataset,
)

__all__ = ["ClfMLP", "make_index_sampler", "make_task",
           "SyntheticLMData", "gaussian_mixture_dataset"]
