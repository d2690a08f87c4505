"""Prototype feature anchoring and prototype-herd exemplar selection (the
JAX package's ``il/prototype.py``).

  * prototypes: per (class, anchor slot) mean of the 3x3-unfolded
    classification-trunk features (256*9 = 2304 values) over the
    positive anchors of the whole dataset, shape ``(C, 9, D)``;
  * the prototype loss: per batch, the NEW classes' current prototypes
    from the positive anchors, averaged over the 9 slots, pushed at least
    ``margin`` (600) in L2 from every stored OLD prototype:
    ``mean(relu(margin - dist)) * weight`` (0.1), after
    ``PrototypeConfig.start_epoch``;
  * prototype-herd sampling, two modes (``ReplayConfig.prototype_herd_mode``):
    ``classmean`` ranks a class's images by the distance between the
    image's slot-averaged class feature and the slot-averaged prototype;
    ``slots`` ranks images per (class, slot) against the per-slot
    prototype, orders the slots by positive count, and spreads the
    per-class budget round-robin over the slot ranks.

Anchor ``k`` of the flat anchor axis is (cell ``k // 9``, slot
``k % 9``). Each dataset pass is one forward per batch under
``torch.no_grad`` (not ``inference_mode``: the model trains next) on the
model's device; the one-hot contractions are plain products there. The
prototype sums of a batch come back as float32 and add up across batches
in float64 on the host; the per-image features come back as float32 and
the distances are ``np.linalg.norm`` on the host, as in JAX, so the
picks equal JAX's.

On the mesh's data axis (``mesh=``) each rank runs its whole batches of a
pass's loader (round robin), and the per-batch sums or per-image scores
are gathered to every rank and reduced or merged in the loader's order:
one process's prototypes, scores and picks, bit for bit
(``parallel.mesh``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boxes import positive_assignment
from ..parallel.mesh import (all_reduce_sum, batch_global, data_active, gather_batches,
                             pass_loader)


def _provider(anchors: Union[np.ndarray, Callable]) -> Callable:
    return anchors if callable(anchors) else (lambda images: anchors)


def _slot_sums(model, anchors, images, boxes, labels, num_classes: int, num_anchors: int):
    """Per image, ``(sums (B, C, 9, D), counts (B, C, 9))``: the unfolded
    classification-trunk features summed over the positive anchors of
    each (assigned final-state label, slot), the one-hot contraction
    ``"csk,cd->ksd"`` of each image, under ``torch.no_grad``."""
    with torch.no_grad():
        unfolded = model.classification_features(images)[3]       # (B, cells, D)
        sums, counts = [], []
        for feat, boxes_i, labels_i in zip(unfolded, boxes, labels):
            pos, a_label = positive_assignment(anchors, boxes_i, labels_i)
            lab = a_label.reshape(-1, num_anchors).long()
            keep = pos.reshape(-1, num_anchors) & (lab >= 0)
            onehot = F.one_hot(torch.clamp(lab, 0, num_classes - 1), num_classes).float() \
                * keep[..., None]                                  # (cells, 9, C)
            s = (onehot.reshape(len(feat), -1).T @ feat).reshape(num_anchors, num_classes, -1)
            sums.append(s.transpose(0, 1))
            counts.append(onehot.sum(dim=0).T)
        return torch.stack(sums), torch.stack(counts)


def _batch_args(provider, batch, device):
    return [torch.tensor(a, device=device)
            for a in (provider(batch.images), batch.images, batch.boxes, batch.labels)]


def make_batch_prototype_fn(model, num_classes: int, num_anchors: int = 9):
    """``fn(anchors, images, boxes, labels) -> (sums (C, 9, D), counts
    (C, 9))``, float32 on the model's device, over the positive anchors
    of the batch. Labels are final-state contiguous ids."""

    def step(anchors, images, boxes, labels):
        sums, counts = _slot_sums(model, anchors, images, boxes, labels, num_classes,
                                  num_anchors)
        return sums.sum(dim=0), counts.sum(dim=0)

    return step


def compute_prototype_features(model, anchors, loader, num_classes: int,
                               mesh=None) -> np.ndarray:
    """Dataset pass -> ``(C, 9, D)`` float32 prototype features.
    ``anchors`` is one ``(A, 4)`` array or a callable ``images ->
    anchors``."""
    provider = _provider(anchors)
    device = next(model.parameters()).device
    step = make_batch_prototype_fn(model, num_classes)
    per_batch = []
    for batch in pass_loader(mesh, loader):
        s, c = step(*_batch_args(provider, batch, device))
        per_batch.append((s.cpu().numpy(), c.cpu().numpy()))
    total = counts = None
    for s, c in gather_batches(mesh, per_batch):          # the loader's order
        s, c = s.astype(np.float64), c.astype(np.float64)
        total = s if total is None else total + s
        counts = c if counts is None else counts + c
    if total is None:
        raise ValueError("empty loader for prototype computation")
    return (total / np.clip(counts[..., None], 1.0, None)).astype(np.float32)


def prototype_loss_from_batch(
    unfolded: torch.Tensor,          # (B, cells, D)
    pos_mask: torch.Tensor,          # (B, A) positive anchors
    assigned_label: torch.Tensor,    # (B, A) final-state labels
    old_prototypes: torch.Tensor,    # (C_old, D): stored prototypes, slot-averaged
    num_past_class: int,
    num_new_class: int,
    num_anchors: int = 9,
    margin: float = 600.0,
    weight: float = 0.1,
    mesh=None,
) -> torch.Tensor:
    """The batch prototype term, for any number of new classes. On the
    mesh's data axis (``mesh=``) the class sums and counts are the global
    batch's (all-reduced), the value the global term's, and the gradient
    reaches through this rank's sums (``parallel.mesh.batch_global``)."""
    b, cells, d = unfolded.shape
    pos = pos_mask.reshape(b, cells, num_anchors)
    lab = assigned_label.reshape(b, cells, num_anchors).long() - num_past_class
    sel = pos & (lab >= 0) & (lab < num_new_class)
    onehot = F.one_hot(torch.clamp(lab, 0, num_new_class - 1), num_new_class).float() \
        * sel[..., None]                                           # (B, cells, 9, K)
    sums = (onehot.reshape(b * cells, -1).T @ unfolded.reshape(b * cells, d)) \
        .reshape(num_anchors, num_new_class, d).transpose(0, 1)    # (K, 9, D)
    counts = onehot.sum(dim=(0, 1)).T                              # (K, 9)
    if data_active(mesh):
        sums = sums + (all_reduce_sum(mesh, sums) - sums.detach())
        counts = all_reduce_sum(mesh, counts)
    cur = (sums / torch.clamp(counts[..., None], min=1.0)).mean(dim=1)   # (K, D)
    diff = cur[:, None, :] - old_prototypes[None].float()
    # the eps inside the sqrt: a zero distance (an all-zero prototype of
    # a class without positives) would give a NaN gradient
    dist = torch.sqrt(torch.sum(diff * diff, dim=2) + 1e-8)
    excess = margin - dist
    return batch_global(mesh, torch.mean(torch.maximum(excess, excess.new_zeros(()))) * weight)


def make_image_feature_fn(model, num_classes: int, num_anchors: int = 9):
    """``fn(anchors, images, boxes, labels) -> ((B, C, D) class
    features, (B, C) positive-anchor counts)``: an image's class feature
    is the mean unfolded feature over that class's positive (cell, slot)
    pairs."""

    def step(anchors, images, boxes, labels):
        sums, counts = _slot_sums(model, anchors, images, boxes, labels, num_classes,
                                  num_anchors)
        sums, counts = sums.sum(dim=2), counts.sum(dim=2)           # over the slots
        return sums / torch.clamp(counts[..., None], min=1.0), counts

    return step


def make_image_slot_feature_fn(model, num_classes: int, num_anchors: int = 9):
    """``fn(anchors, images, boxes, labels) -> ((B, C, 9, D) per-slot
    class features, (B, C, 9) positive counts)``: the per-(class, slot)
    mean unfolded feature of each image."""

    def step(anchors, images, boxes, labels):
        sums, counts = _slot_sums(model, anchors, images, boxes, labels, num_classes,
                                  num_anchors)
        return sums / torch.clamp(counts[..., None], min=1.0), counts

    return step


def prototype_herd_slot_scores(model, anchors, dataset, data_cfg, prototypes: np.ndarray,
                               mesh=None):
    """Per-(class, anchor slot) ranking data of the ``slots`` mode:
    ``(scores, counts)`` with ``scores[cls][slot] = {img_id: L2
    distance}`` for the images with at least one positive anchor of
    ``cls`` in ``slot``, and ``counts`` ``(C, 9)`` float64, the positive
    anchors per slot over the dataset (which ranks the slots)."""
    from ..data.loader import BatchLoader

    num_classes, num_anchors = prototypes.shape[:2]
    provider = _provider(anchors)
    device = next(model.parameters()).device
    step = make_image_slot_feature_fn(model, num_classes, num_anchors)
    loader = BatchLoader(dataset, data_cfg, shuffle=False, augment=False)
    per_batch = []
    for batch in pass_loader(mesh, loader):
        feat, cnt = step(*_batch_args(provider, batch, device))
        feat, cnt = feat.cpu().numpy(), cnt.cpu().numpy()          # (B,C,9,D), (B,C,9)
        rows = []
        for b, img_id in enumerate(batch.image_ids.tolist()):
            dists = [(int(c), int(s), float(np.linalg.norm(feat[b, c, s] - prototypes[c, s])))
                     for c, s in zip(*np.nonzero(cnt[b]))]
            rows.append((img_id, cnt[b], dists))
        per_batch.append(rows)
    scores = {c: {s: {} for s in range(num_anchors)} for c in range(num_classes)}
    counts = np.zeros((num_classes, num_anchors), np.float64)
    seen = set()
    for rows in gather_batches(mesh, per_batch):          # the loader's order
        for img_id, cnt, dists in rows:
            if img_id in seen:
                continue
            seen.add(img_id)
            counts += cnt
            for c, s, d in dists:
                scores[c][s][img_id] = d
    return scores, counts


def sample_by_slot_scores(
    scores, counts: np.ndarray, per_num: int, classes,
    already: Optional[List[int]] = None,
    exclude: Optional[set] = None,
    num_anchors: int = 9,
) -> Dict[int, List[int]]:
    """The ``slots`` pick: the per-class budget ``per_num`` is split
    round-robin over slot *ranks* (slots sorted by positive count,
    descending, stable); each rank takes its share closest-first from
    that slot's list, skipping taken and excluded (future-class) images.
    ``classes`` restricts the pick to the state's new classes."""
    taken = set(already or [])
    exclude = exclude or set()
    share = [0] * num_anchors
    i = 0
    for _ in range(per_num):
        share[i] += 1
        i = (i + 1) % num_anchors
    out: Dict[int, List[int]] = {}
    for cls in classes:
        ranked = np.argsort(-counts[cls], kind="stable")
        picked: List[int] = []
        for idx, slot in enumerate(ranked):
            need = share[idx]
            if need == 0:
                continue
            slot_scores = scores[cls][int(slot)]
            for img_id in sorted(slot_scores, key=slot_scores.get):
                if img_id in taken or img_id in exclude:
                    continue
                picked.append(img_id)
                taken.add(img_id)
                need -= 1
                if need == 0:
                    break
        if picked:
            out[cls] = picked
    return out


def prototype_herd_scores(model, anchors, dataset, data_cfg, prototypes: np.ndarray,
                          mesh=None) -> Dict[int, Dict[int, float]]:
    """Per (class, image) distances of the ``classmean`` mode: an image's
    class feature against the slot-averaged class prototype."""
    from ..data.loader import BatchLoader

    num_classes = prototypes.shape[0]
    provider = _provider(anchors)
    device = next(model.parameters()).device
    step = make_image_feature_fn(model, num_classes)
    proto_mean = prototypes.mean(axis=1)                           # (C, D)
    loader = BatchLoader(dataset, data_cfg, shuffle=False, augment=False)
    per_batch = []
    for batch in pass_loader(mesh, loader):
        feat, cnt = step(*_batch_args(provider, batch, device))
        feat, cnt = feat.cpu().numpy(), cnt.cpu().numpy()          # (B,C,D), (B,C)
        per_batch.append([(img_id, [(int(cls), float(np.linalg.norm(feat[b, cls]
                                                                     - proto_mean[cls])))
                                    for cls in np.where(cnt[b] > 0)[0]])
                          for b, img_id in enumerate(batch.image_ids.tolist())])
    scores: Dict[int, Dict[int, float]] = {c: {} for c in range(num_classes)}
    seen = set()
    for rows in gather_batches(mesh, per_batch):          # the loader's order
        for img_id, dists in rows:
            if img_id in seen:
                continue
            seen.add(img_id)
            for cls, d in dists:
                scores[cls][img_id] = d
    return scores


def sample_by_scores(scores: Dict[int, Dict[int, float]], per_num: int,
                     already: Optional[List[int]] = None) -> Dict[int, List[int]]:
    """Closest first per class, no reuse (herding's last step)."""
    taken = set(already or [])
    out: Dict[int, List[int]] = {}
    for cls, img_score in scores.items():
        picked = []
        for img_id in sorted(img_score, key=img_score.get):
            if img_id in taken:
                continue
            picked.append(img_id)
            taken.add(img_id)
            if len(picked) == per_num:
                break
        if picked:
            out[cls] = picked
    return out
