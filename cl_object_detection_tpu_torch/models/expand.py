"""Classifier expansion between incremental states (the JAX package's
``models/expand.py``), on the port's state dict.

The classification output conv stores classes anchor-major: output
channel ``a*C + c``, so its OIHW weight reshapes to ``(A, C, cin, kh,
kw)`` and its bias to ``(A, C)``; the old classes keep their slots and
the new ones are appended per anchor.

Warm-start methods:
  * ``mean``: each new class = similarity-weighted mixture of the old
    classes' filters and biases, added onto the prior bias;
  * ``large``: a copy of the most similar old class's filter and bias;
  * ``onlyNegative``: only the negative weights of the most similar old
    class (the argmax, as JAX takes it);
  * anything else: zero filters and the prior bias.

The arithmetic is JAX's float32 numpy loop in JAX's order (``mean`` adds
``ratio * old[i]`` for i = 0..C_old-1), so the expanded weights equal
JAX's bit for bit through ``models.bridge``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

HEAD_WEIGHT = "classification_head.output.weight"
HEAD_BIAS = "classification_head.output.bias"


def expand_classifier(
    state_dict: Mapping[str, torch.Tensor],
    num_new_classes: int,
    *,
    num_anchors: int = 9,
    prior: float = 0.01,
    similarity: Optional[np.ndarray] = None,   # (num_new, num_old)
    method: str = "mean",
) -> Dict[str, torch.Tensor]:
    """A new state dict whose classification output conv has grown by
    ``num_new_classes`` (load it into a model built at the new class
    count). The input is not changed; the grown tensors stay on its
    device."""
    weight, bias = state_dict[HEAD_WEIGHT], state_dict[HEAD_BIAS]
    kernel = weight.detach().cpu().numpy()               # (A*C_old, cin, kh, kw)
    b = bias.detach().cpu().numpy()
    total, cin, kh, kw = kernel.shape
    c_old = total // num_anchors
    c_new = c_old + num_new_classes
    bias_val = -math.log((1.0 - prior) / prior)

    k_old = kernel.reshape(num_anchors, c_old, cin, kh, kw)
    b_old = b.reshape(num_anchors, c_old)
    k_new = np.zeros((num_anchors, c_new, cin, kh, kw), kernel.dtype)
    b_new = np.full((num_anchors, c_new), bias_val, b.dtype)
    k_new[:, :c_old] = k_old
    b_new[:, :c_old] = b_old

    if similarity is not None and method in ("mean", "large", "onlyNegative"):
        sim = np.asarray(similarity, np.float32)
        for j in range(num_new_classes):
            if method == "mean":
                for i, ratio in enumerate(sim[j]):
                    k_new[:, c_old + j] += ratio * k_old[:, i]
                    b_new[:, c_old + j] += ratio * b_old[:, i]
                continue
            i = int(np.argmax(sim[j]))
            if method == "large":
                k_new[:, c_old + j] = k_old[:, i]
                b_new[:, c_old + j] = b_old[:, i]
            else:
                w = k_old[:, i]
                k_new[:, c_old + j] = np.where(w < 0, w, 0.0)

    out = dict(state_dict)
    out[HEAD_WEIGHT] = torch.from_numpy(
        k_new.reshape(num_anchors * c_new, cin, kh, kw)).to(weight.device)
    out[HEAD_BIAS] = torch.from_numpy(b_new.reshape(num_anchors * c_new)).to(bias.device)
    return out


def classifier_class_vectors(state_dict: Mapping[str, torch.Tensor],
                             num_anchors: int = 9) -> np.ndarray:
    """Per-class flattened classifier weights ``(C, A*kh*kw*cin)`` in the
    JAX package's order (per class: anchor, then the HWIO kernel's
    kh, kw, cin), float32 numpy."""
    kernel = state_dict[HEAD_WEIGHT].detach().cpu().numpy()
    total, cin, kh, kw = kernel.shape
    c = total // num_anchors
    k = kernel.reshape(num_anchors, c, cin, kh, kw).transpose(1, 0, 3, 4, 2)
    return k.reshape(c, num_anchors * kh * kw * cin)
