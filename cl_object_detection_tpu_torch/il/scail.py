"""SCAIL-style classifier weight standardization (the JAX package's
``il/scail.py``), on the port's state dict.

  * ``ranked_mean``: per-class weights sorted descending, averaged across
    classes: the old classes' canonical sorted weight profile;
  * ``standardize_new_classifier``: rescale each new class's filter so
    its norm equals the norm of the old classes' ranked mean.

numpy float32, in JAX's order, so the result equals JAX's bit for bit.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.expand import HEAD_WEIGHT, classifier_class_vectors


def ranked_mean(class_vectors: np.ndarray) -> np.ndarray:
    """(C, D) -> (D,) mean of per-class descending-sorted weights."""
    s = -np.sort(-class_vectors, axis=1)
    return s.mean(axis=0)


def standardize_new_classifier(
    state_dict: Mapping[str, torch.Tensor],
    num_past_class: int,
    num_anchors: int = 9,
) -> Dict[str, torch.Tensor]:
    """A new state dict whose new-class output-conv filters (classes
    ``num_past_class`` and up) are rescaled to the old classes'
    ranked-mean norm; zero filters stay as they are."""
    weight = state_dict[HEAD_WEIGHT]
    kernel = weight.detach().cpu().numpy()
    total, cin, kh, kw = kernel.shape
    c = total // num_anchors

    vecs = classifier_class_vectors(state_dict, num_anchors)   # (C, D)
    old_profile = ranked_mean(vecs[:num_past_class])
    old_norm = np.linalg.norm(old_profile)

    k = kernel.reshape(num_anchors, c, cin, kh, kw).copy()
    for j in range(num_past_class, c):
        nj = np.linalg.norm(vecs[j])
        if nj > 1e-12 and old_norm > 1e-12:
            k[:, j] *= old_norm / nj
    out = dict(state_dict)
    out[HEAD_WEIGHT] = torch.from_numpy(k.reshape(total, cin, kh, kw)).to(weight.device)
    return out
