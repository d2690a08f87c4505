"""Similarity-based classifier warm-start (the JAX package's
``il/weight_init.py``).

Over the new state's training images, for the anchors that have IoU >=
0.5 with a new-class GT and whose old-class probabilities sum to >= 0.5,
the old model's normalized class distribution is accumulated per new
class; averaged per image, then across the images where the class
appears; entries below 0.05 are zeroed and the matrix is divided by its
global sum. The ``(n_new, n_old)`` result feeds
``models.expand.expand_classifier`` (methods ``mean``, ``large``,
``onlyNegative``).

The forward is one batched call per batch under ``torch.no_grad`` (not
``inference_mode``: the model trains next, and tensors cached under
inference mode would break its backward), on the model's device; the
per-image sums come back to the host and add up in float64. On the
mesh's data axis (``mesh=``) each rank runs its whole batches of the
loader, round robin, every batch's sums are gathered to every rank, and
each adds them up in the loader's order: the matrix one process gives,
bit for bit (``parallel.mesh``).
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from ..ops.boxes import positive_assignment
from ..parallel.mesh import gather_batches, pass_loader


def make_similarity_step(model, num_new: int, num_old: int, threshold: float = 0.5):
    """``fn(anchors, images, boxes, labels) -> (sums (n_new, n_old),
    appearances (n_new,))``, float32 tensors on the model's device: per
    new class, the sum over images of the mean old-class distribution of
    its selected anchors, and the number of images where it has any."""

    @torch.no_grad()
    def step(anchors, images, boxes, labels):
        cls, _ = model(images, enable_act=True)
        cls = torch.clamp(cls.float(), 1e-4, 1 - 1e-4)
        sums = cls.new_zeros((num_new, num_old))
        appears = cls.new_zeros((num_new,))
        for p, boxes_i, labels_i in zip(cls, boxes, labels):
            pos, assigned = positive_assignment(anchors, boxes_i, labels_i)
            old_sum = p.sum(dim=1)                  # the model has only old classes
            sel = pos & (old_sum >= threshold)
            dist = p / torch.clamp(old_sum[:, None], min=1e-8)
            # labels are final-state contiguous: new classes occupy
            # [num_old, num_old + num_new)
            a_label = assigned.long() - num_old
            keep = sel & (a_label >= 0) & (a_label < num_new)
            onehot = torch.nn.functional.one_hot(
                torch.clamp(a_label, 0, num_new - 1), num_new).float() * keep[:, None]
            class_sums = onehot.T @ dist            # (n_new, n_old)
            counts = onehot.sum(dim=0)              # anchors per new class
            appear = (counts > 0).float()
            sums += class_sums / torch.clamp(counts[:, None], min=1.0) * appear[:, None]
            appears += appear
        return sums, appears

    return step


def compute_similarity(model, anchors: Union[np.ndarray, Callable], loader,
                       num_new: int, num_old: int, mesh=None) -> np.ndarray:
    """The ``(num_new, num_old)`` float32 similarity matrix over
    ``loader`` (built with ``augment=False, shuffle=False``). ``anchors``
    is one ``(A, 4)`` array or a callable ``images -> anchors`` (landscape
    and portrait frames have different grids). Runs where ``model`` lives."""
    provider = anchors if callable(anchors) else (lambda images: anchors)
    device = next(model.parameters()).device
    step = make_similarity_step(model, num_new, num_old)
    per_batch = []
    for batch in pass_loader(mesh, loader):
        args = [torch.tensor(a, device=device)
                for a in (provider(batch.images), batch.images, batch.boxes, batch.labels)]
        s, c = step(*args)
        per_batch.append((s.cpu().numpy(), c.cpu().numpy()))
    total = np.zeros((num_new, num_old), np.float64)
    count = np.zeros((num_new,), np.float64)
    for s, c in gather_batches(mesh, per_batch):          # the loader's order
        total += s
        count += c
    sim = total / np.clip(count[:, None], 1.0, None)
    sim = np.where(sim > 0.05, sim, 0.0)
    denom = sim.sum()
    if denom > 0:
        sim = sim / denom
    return sim.astype(np.float32)
