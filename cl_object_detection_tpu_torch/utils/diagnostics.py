"""Classifier-weight forgetting diagnostics (the JAX package's
``utils/diagnostics.py``), on the port's state dict.

The classification output conv's per-class filters are de-interleaved
across the anchor slots (``models.expand.classifier_class_vectors``, in
the JAX package's order) and plotted as (a) the weight norm per class
and (b) the ranked mean weight, old against new classes: quick visual
checks for classifier imbalance between states.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..models.expand import classifier_class_vectors


def classifier_weight_norms(state_dict: Mapping[str, torch.Tensor],
                            num_anchors: int = 9) -> np.ndarray:
    """(C,) L2 norm of each class's de-interleaved filter."""
    vecs = classifier_class_vectors(state_dict, num_anchors)
    return np.linalg.norm(vecs, axis=1)


def ranked_mean_weights(state_dict: Mapping[str, torch.Tensor],
                        num_anchors: int = 9) -> np.ndarray:
    """(C, D) per-class weights sorted descending."""
    vecs = classifier_class_vectors(state_dict, num_anchors)
    return -np.sort(-vecs, axis=1)


def plot_classifier_diagnostics(
    state_dict: Mapping[str, torch.Tensor],
    class_names: Sequence[str],
    num_past_class: int = 0,
    out_path: Optional[str] = None,
    num_anchors: int = 9,
):
    """Weight-norm bar chart + old-vs-new ranked-mean curves. Returns the
    matplotlib figure (closed when ``out_path`` is given, so looping
    callers do not leak figures). matplotlib is imported here, when
    called: the package does not need it otherwise. The process-global
    backend is left untouched; set MPLBACKEND=Agg for headless runs."""
    import matplotlib.pyplot as plt

    norms = classifier_weight_norms(state_dict, num_anchors)
    ranked = ranked_mean_weights(state_dict, num_anchors)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
    colors = ["tab:blue"] * num_past_class + ["tab:red"] * (len(norms) - num_past_class)
    ax1.bar(range(len(norms)), norms, color=colors)
    ax1.set_xticks(range(len(norms)))
    ax1.set_xticklabels(class_names, rotation=60, ha="right", fontsize=8)
    ax1.set_title("classifier weight norm per class (red = new)")

    if num_past_class:
        ax2.plot(ranked[:num_past_class].mean(axis=0), label="old classes")
    if num_past_class < len(norms):
        ax2.plot(ranked[num_past_class:].mean(axis=0), label="new classes")
    ax2.set_title("ranked mean weight")
    ax2.set_xlabel("weight rank")
    ax2.legend()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
    return fig
