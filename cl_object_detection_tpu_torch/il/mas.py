"""Memory-Aware Synapses importance (the JAX package's ``il/mas.py``).

The importance of a parameter is the mean over the dataset of
``|d ||output||^2 / d theta|``, where the output norm of a batch is

    sum(sigmoid(cls)^2) / (B * C)  +  mean_b( mean |reg[positives_b]| )

in float32, the positives of each image from
``ops.boxes.positive_assignment``. The frozen-BN affines (every module
named ``bn*``) and the classification output conv are excluded; the
downsample BN affines (``downsample_bn``) keep their importance, as in
JAX. The penalty itself is ``il.losses.mas_penalty``.

Each batch is one forward and one ``torch.autograd.grad`` under grad
(never ``inference_mode``: the model trains next, and tensors cached
under inference mode would break its backward), on the model's device;
the gradients land in fresh tensors, not in the parameters' ``.grad``
(the train step's accumulator). The importance is a dict keyed by the
port's parameter names. On the mesh (``mesh=``) each rank of every axis sums
|grad| over its whole batches of the loader (round robin) on its device;
one flat float32 all-reduce adds the ranks' sums (the same bits on every
rank), divided by the global batch count. The order of the sum differs
from one process's, so the importance equals it to float32 rounding
(``parallel.mesh``).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Union

import numpy as np
import torch

from ..ops.boxes import positive_assignment
from ..parallel.mesh import all_reduce_sum, all_reduce_sums, pass_loader


def _excluded(name: str) -> bool:
    """A frozen-BN leaf (some dot-separated component starts with ``bn``:
    ``backbone.bn1.weight``, ``backbone.layer1_0.bn2.bias``; not
    ``downsample_bn``) or a leaf of the classification output conv."""
    parts = name.split(".")
    if any(p.startswith("bn") for p in parts):
        return True
    return any(a == "classification_head" and b == "output"
               for a, b in zip(parts, parts[1:]))


def importance_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """1.0 for included leaves, 0.0 for excluded ones (BN, the
    classification output), by parameter name."""
    return {name: (torch.zeros_like if _excluded(name) else torch.ones_like)(
        p, dtype=torch.float32) for name, p in params.items()}


def make_importance_step(model: torch.nn.Module):
    """``fn(anchors, images, boxes, labels) -> {name: |grad|}``: the
    absolute gradient of the batch's output norm for every parameter of
    ``model``, float32 tensors on its device."""
    names, params = zip(*model.named_parameters())

    def output_norm(anchors, images, boxes, labels):
        cls, reg = model(images, enable_act=True)
        cls, reg = cls.float(), reg.float()
        b, _, c = cls.shape
        per_image = []
        for reg_i, boxes_i, labels_i in zip(reg, boxes, labels):
            pos, _ = positive_assignment(anchors, boxes_i, labels_i)
            n = pos.float().sum()
            mean_abs = torch.where(pos[:, None], torch.abs(reg_i), 0.0).sum() / torch.clamp(
                n * 4.0, min=1.0)
            per_image.append(torch.where(n > 0, mean_abs, 0.0))
        reg_norm = torch.stack(per_image).mean()
        cls_norm = torch.sum(cls * cls) / (b * c)
        return cls_norm + reg_norm

    def step(anchors, images, boxes, labels):
        with torch.enable_grad():
            grads = torch.autograd.grad(output_norm(anchors, images, boxes, labels), params,
                                        allow_unused=True)
        return {n: torch.zeros_like(p, dtype=torch.float32) if g is None else torch.abs(g)
                for n, p, g in zip(names, params, grads)}

    return step


def compute_importance(model: torch.nn.Module, anchors: Union[np.ndarray, Callable], loader,
                       mesh=None) -> Dict[str, torch.Tensor]:
    """Mean |grad| of the output norm over ``loader``, per parameter,
    zeroed on the excluded leaves: {name: float32 tensor on the model's
    device}. ``anchors`` is one ``(A, 4)`` array or a callable
    ``images -> anchors``."""
    provider = anchors if callable(anchors) else (lambda images: anchors)
    device = next(model.parameters()).device
    step = make_importance_step(model)
    params = dict(model.named_parameters())
    acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    n = 0
    for batch in pass_loader(mesh, loader):
        args = [torch.tensor(a, device=device)
                for a in (provider(batch.images), batch.images, batch.boxes, batch.labels)]
        g = step(*args)
        torch._foreach_add_(list(acc.values()), [g[k] for k in acc])
        n += 1
    # the pass's batches are split over every rank of the mesh
    acc = all_reduce_sums(mesh, acc, axis="world")
    n = int(all_reduce_sum(mesh, torch.tensor(float(n)), axis="world"))
    if n:
        torch._foreach_div_(list(acc.values()), float(n))
    mask = importance_mask(params)
    return {k: v * mask[k] for k, v in acc.items()}
