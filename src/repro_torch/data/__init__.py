"""Datasets (the classification task's, the synthetic LM stream) and the
classification task."""
from repro_torch.data.classification import (
    ClfMLP, clf_logits, clf_loss, init_clf, make_index_sampler, make_task,
)
from repro_torch.data.pipeline import (
    SyntheticLMData, gaussian_mixture_dataset,
)

__all__ = ["ClfMLP", "make_index_sampler", "make_task", "init_clf",
           "clf_logits", "clf_loss", "SyntheticLMData",
           "gaussian_mixture_dataset"]
