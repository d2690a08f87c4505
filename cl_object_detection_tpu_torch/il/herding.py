"""Herding exemplar selection (the JAX package's ``il/herding.py``).

For the PREVIOUS state's training set:
  1. per (image, class): the foreground-area ratio by pairwise
     inclusion-exclusion over that class's boxes (the sum of the areas
     less the lower-triangle pairwise intersections); pairs with a ratio
     >= ``ratio_threshold`` (0.25) are kept;
  2. per class: the mean feature vector over its kept images, where an
     image's vector is its five FPN maps resized to the fixed squares
     ``FEATURE_SIZES``, flattened in NHWC order and concatenated
     (23,239 x 256 values);
  3. each kept image scored by the L2 distance to its class mean,
     images holding a FUTURE class excluded;
  4. the ``per_num`` closest per class, no image reused across classes.

The forward and the resize run batched on the model's device under
``torch.no_grad`` (not ``inference_mode``: the model trains next). The
vectors come to the host, where the class means add up in float32 in
loader order and the distances are ``np.linalg.norm``, as in JAX, so
the picks equal JAX's: an on-card reduction in another order could swap
two near-equal distances.

On the mesh's data axis (``mesh=``) each rank runs its whole batches of
the unshuffled loader, round robin. Pass 1: rank 0 gathers every batch's
vectors, one round of W batches at a time (``dist.gather``: only rank 0
receives, and holds one round), adds them up in loader order in float32
as one process does, and broadcasts the class means. Pass 2: each rank
measures its images' distances, gathered as scalars to every rank and
merged in loader order. The picks are one process's, bit for bit.

The resize is ``jax.image.resize(..., "bilinear")``'s: half-pixel
centres, a triangle kernel widened by the shrink factor when it shrinks
(antialiasing), weights renormalized at the edges; ``resize_bilinear``
builds those weights as one ``(out, in)`` matrix per axis and applies
the height's, then the width's.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

FEATURE_SIZES = (132, 66, 33, 17, 9)
RATIO_THRESHOLD = 0.25


def foreground_ratio(boxes: np.ndarray, labels: np.ndarray, img_area: float) -> Dict[int, float]:
    """Per-class fg-area ratio by inclusion-exclusion over pairs."""
    out: Dict[int, float] = {}
    for cls in np.unique(labels[labels >= 0]):
        bb = boxes[labels == cls]
        x1 = np.maximum(bb[:, None, 0], bb[None, :, 0])
        y1 = np.maximum(bb[:, None, 1], bb[None, :, 1])
        x2 = np.minimum(bb[:, None, 2], bb[None, :, 2])
        y2 = np.minimum(bb[:, None, 3], bb[None, :, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area = float(np.trace(inter)) - float(np.tril(inter, -1).sum())
        out[int(cls)] = area / max(img_area, 1.0)
    return out


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``jax.image.resize``'s bilinear weights along one axis, ``(out,
    in)`` float32, computed as JAX computes them (its
    ``compute_weight_mat`` with antialiasing, no translation)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], weights, np.float32(0)).T,
                                dtype=np.float32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` of an NCHW float map to
    ``(out_h, out_w)``; an axis whose size does not change is left as it
    is, as JAX leaves it."""
    h, w = x.shape[-2:]
    if h != out_h:
        wh = torch.from_numpy(resize_weights(h, out_h)).to(x.device)
        x = torch.matmul(wh, x)
    if w != out_w:
        ww = torch.from_numpy(resize_weights(w, out_w)).to(x.device)
        x = torch.matmul(x, ww.T)
    return x


def feature_dim(model) -> int:
    """The length of ``make_feature_fn``'s vector of one image."""
    return sum(s * s for s in FEATURE_SIZES) * model.fpn.p3_smooth.weight.shape[0]


def make_feature_fn(model):
    """``fn(images) -> (B, 23239 * 256)`` float32 on the model's device:
    each image's FPN maps resized to ``FEATURE_SIZES``, flattened NHWC,
    concatenated."""

    @torch.no_grad()
    def features(images: torch.Tensor) -> torch.Tensor:
        feats = model.forward_features(images)
        parts = []
        for f, s in zip(feats, FEATURE_SIZES):
            r = resize_bilinear(f.float(), s, s)
            parts.append(r.permute(0, 2, 3, 1).reshape(f.shape[0], -1))
        return torch.cat(parts, dim=1)

    return features


class HerdSampler:
    """Exemplar book-keeping across states: ``examplar_dict`` (class ->
    its image ids) and ``examplar_list`` (every pick, in pick order)."""

    def __init__(self, ratio_threshold: float = RATIO_THRESHOLD):
        self.ratio_threshold = ratio_threshold
        self.examplar_dict: Dict[int, List[int]] = defaultdict(list)
        self.examplar_list: List[int] = []

    def sample(
        self,
        model,                    # the PREVIOUS state's model, on its device
        dataset,                  # ILDataset over the PREVIOUS state (train split)
        data_cfg,
        per_num: int,
        future_img_ids: Sequence[int] = (),
        mesh=None,
    ) -> Dict[int, List[int]]:
        """Pick up to ``per_num`` new exemplars per class; returns {class:
        ids} of this call and extends the book-keeping. On the mesh's data
        axis (``mesh=``) the passes split the loader's batches over the
        ranks (module docstring)."""
        from ..data.loader import BatchLoader
        from ..parallel.mesh import (active, broadcast_arrays, gather_batches,
                                     gather_to_primary, pass_loader)

        future = set(future_img_ids)
        device = next(model.parameters()).device
        feature_fn = make_feature_fn(model)

        # 1. classify images by fg ratio
        classified: Dict[int, List[int]] = defaultdict(list)
        for i in range(len(dataset)):
            img_id = dataset.image_ids[i]
            boxes, labels, _ = dataset.load_annotations(i)
            h, w = dataset.image_size(i)
            for cls, ratio in foreground_ratio(boxes, labels, float(h * w)).items():
                if ratio >= self.ratio_threshold:
                    classified[cls].append(img_id)

        img_classes: Dict[int, List[int]] = defaultdict(list)
        for cls, ids in classified.items():
            for img_id in ids:
                img_classes[img_id].append(cls)

        # 2-3. two streaming passes (class means, then distances): one
        # ~24 MB vector per image, so the host holds O(classes) vectors
        loader = BatchLoader(dataset, data_cfg, shuffle=False, augment=False)

        def vectors(batch) -> np.ndarray:
            return feature_fn(torch.from_numpy(batch.images).to(device)).cpu().numpy()

        # pass 1, class means: rank 0 sums every round's W batches in the
        # loader's order; a rank past the last batch sends zeros, unread
        sums: Dict[int, np.ndarray] = {}
        counts: Dict[int, int] = defaultdict(int)
        done = set()
        rank, world = (mesh.rank, mesh.world) if active(mesh) else (0, 1)
        mine = iter(pass_loader(mesh, loader))
        total = len(loader)
        for first in range(0, total, world):               # one round of W batches
            batch = next(mine) if first + rank < total else None
            f = (feature_fn(torch.from_numpy(batch.images).to(device)) if batch is not None
                 else torch.zeros(loader.batch_size, feature_dim(model), device=device))
            got = gather_to_primary(mesh, f, None if batch is None
                                    else batch.image_ids.tolist())
            for ids, v in got or ():                   # rank 0, in loader order
                for b, img_id in enumerate(ids or ()):
                    if img_id in done or img_id not in img_classes:
                        continue
                    done.add(img_id)
                    for cls in img_classes[img_id]:
                        if cls in sums:
                            sums[cls] += v[b].numpy()
                        else:
                            sums[cls] = v[b].numpy().astype(np.float32).copy()
                        counts[cls] += 1
        means = broadcast_arrays(mesh, {c: sums[c] / counts[c] for c in sums}
                                 if rank == 0 else None)

        per_batch = []
        for batch in pass_loader(mesh, loader):    # pass 2: distances
            f = vectors(batch)
            per_batch.append([
                (img_id, [] if img_id in future else
                 [(cls, float(np.linalg.norm(means[cls] - f[b])))
                  for cls in img_classes.get(img_id, ()) if cls in means])
                for b, img_id in enumerate(batch.image_ids.tolist())])
        scores: Dict[int, Dict[int, float]] = {c: {} for c in classified}
        done = set()
        for rows in gather_batches(mesh, per_batch):   # the loader's order
            for img_id, dists in rows:
                if img_id in done or img_id not in img_classes:
                    continue
                done.add(img_id)
                if img_id in future:
                    continue
                for cls, d in dists:
                    scores[cls][img_id] = d

        # 4. closest first per class, no image reused
        new_dict: Dict[int, List[int]] = defaultdict(list)
        for cls, img_score in scores.items():
            count = 0
            for img_id in sorted(img_score, key=img_score.get):
                if img_id in self.examplar_list:
                    continue
                new_dict[cls].append(img_id)
                self.examplar_list.append(img_id)
                count += 1
                if count == per_num:
                    break
        for cls, ids in new_dict.items():
            self.examplar_dict[cls].extend(ids)
        return dict(new_dict)
