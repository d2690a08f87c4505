"""Static-shape detection post-processing: logit top-k + padded
class-aware NMS (the JAX package's ``ops/nms.py``).

Data-dependent filtering becomes top-k plus validity masks, and class
awareness uses the class-offset trick. The functions take a batch
dimension directly where the JAX package vmaps a per-image function.
Every top-k is a stable descending sort, so ties keep the lower index
first as ``lax.top_k`` does (a fresh model's zero output convs make every
logit tie).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import library


class Detections(NamedTuple):
    boxes: torch.Tensor    # (..., D, 4) xyxy
    scores: torch.Tensor   # (..., D)
    labels: torch.Tensor   # (..., D) int32
    valid: torch.Tensor    # (..., D) bool


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_topk(x: torch.Tensor, k: int, method: str):
    """``"exact"``: ``lax.top_k`` in the input's dtype. ``"approx"``:
    ``lax.approx_max_k`` on float32 values, which XLA lowers off the TPU
    to an exact sort (``ApproxTopK`` with ``is_fallback``): the same
    stable top-k of the float32 cast, ties to the lower index."""
    return _topk_stable(x.float() if method == "approx" else x, k)


def _select_candidates(cls_prob, score_thresh, pre_nms_topk, topk_method,
                       scores_are_logits):
    """Pre-NMS candidate select over (B, A, C):
    (cand_scores (B,k), cand_labels (B,k) int32, idx (B,k))."""
    if topk_method not in ("exact", "approx"):
        raise ValueError(f"unknown topk_method {topk_method!r}")
    raw, labels = torch.max(cls_prob, dim=-1)
    labels = labels.to(torch.int32)
    k = min(pre_nms_topk, raw.shape[-1])
    if scores_are_logits:
        top_raw, idx = _select_topk(raw, k, topk_method)
        cand = torch.sigmoid(top_raw.float())
        cand = torch.where(cand > score_thresh, cand, torch.zeros_like(cand))
        return cand, torch.gather(labels, -1, idx), idx
    scores = torch.where(raw > score_thresh, raw, torch.zeros_like(raw))
    cand, idx = _select_topk(scores, k, topk_method)
    return cand, torch.gather(labels, -1, idx), idx


def _decode_offset(cand_labels, idx, regression, anchors, height, width,
                   bbox_std):
    """Decode + clip the k candidates of each image; returns
    (boxes, class-offset boxes), both (B, k, 4). The offset translates
    each class to its own coordinate range, so plain NMS is class-aware."""
    from .boxes import clip_boxes, decode_boxes

    cand_deltas = torch.gather(
        regression, 1, idx[..., None].expand(*idx.shape, 4)).float()
    cand_anchors = anchors[idx]
    cand_boxes = clip_boxes(
        decode_boxes(cand_anchors, cand_deltas, std=bbox_std), height, width)
    span = cand_boxes.amax(dim=(-2, -1), keepdim=True) + 1.0
    offset = cand_labels.to(cand_boxes.dtype)[..., None] * span
    return cand_boxes, cand_boxes + offset


def _post_nms(keep, cand_boxes, cand_scores, cand_labels, score_thresh,
              max_detections) -> Detections:
    kept_scores = torch.where(keep, cand_scores, torch.zeros_like(cand_scores))
    d = min(max_detections, kept_scores.shape[-1])
    out_scores, oidx = _topk_stable(kept_scores, d)
    return Detections(
        boxes=torch.gather(cand_boxes, -2, oidx[..., None].expand(*oidx.shape, 4)),
        scores=out_scores,
        labels=torch.gather(cand_labels, -1, oidx),
        valid=out_scores > score_thresh,
    )


def detect_batch(
    cls_prob: torch.Tensor,    # (B, A, C) probabilities or logits
    regression: torch.Tensor,  # (B, A, 4)
    anchors: torch.Tensor,     # (A, 4)
    *,
    height: int,
    width: int,
    score_thresh: float = 0.05,
    iou_thresh: float = 0.5,
    pre_nms_topk: int = 1024,
    max_detections: int = 300,
    scores_are_logits: bool = False,
    nms_impl: str | None = None,
    topk_method: str = "exact",
    bbox_std=(0.1, 0.1, 0.2, 0.2),
) -> Detections:
    """Batched detection: top-k on scores (or logits, with the sigmoid on
    the k survivors only), decode + clip of the candidates, class-aware
    NMS, and the final top ``max_detections``.

    ``nms_impl``: ``"scan"`` (sequential greedy), ``"iterative"``
    (fixed-point) or ``"pallas_fp"`` (``ops.nms_fp.nms_fp``: the CUDA
    kernel for CUDA tensors at any k, its plain version for CPU
    tensors; legacy ``"pallas"`` aliases it). All give identical keep
    masks."""
    impl = nms_impl or "scan"
    if impl == "pallas":
        impl = "pallas_fp"
    if impl not in ("pallas_fp", "iterative", "scan"):
        raise ValueError(f"unknown nms_impl {impl!r}")
    cand_scores, cand_labels, idx = _select_candidates(
        cls_prob, score_thresh, pre_nms_topk, topk_method, scores_are_logits)
    cand_boxes, off_boxes = _decode_offset(
        cand_labels, idx, regression, anchors, height, width, bbox_std)
    if impl == "pallas_fp":
        from .nms_fp import nms_fp

        keep = nms_fp(off_boxes, cand_scores, iou_thresh)
    elif impl == "iterative":
        # the opaque operator around nms_iterative, so torch.export can
        # trace the path (ops/library.py)
        keep = library.nms_iterative(off_boxes, cand_scores, float(iou_thresh))
    else:
        keep = nms_padded(off_boxes, cand_scores, iou_thresh)
    return _post_nms(keep, cand_boxes, cand_scores, cand_labels,
                     score_thresh, max_detections)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., k, 4) -> (..., k, k) IoU in the division form
    inter / max(area_i + area_j - inter, 1e-8)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    inter = iw * ih
    return inter / (areas[..., :, None] + areas[..., None, :] - inter).clamp(min=1e-8)


def _thresh(iou_thresh: float, like: torch.Tensor) -> torch.Tensor:
    # compare in float32, as the JAX package does with a weak-typed float
    return torch.tensor(iou_thresh, dtype=torch.float32, device=like.device)


def nms_padded(
    boxes: torch.Tensor,   # (..., k, 4) sorted by descending score
    scores: torch.Tensor,  # (..., k)
    iou_thresh: float,
) -> torch.Tensor:
    """Greedy hard NMS, sequential over k: a box survives unless an
    earlier surviving box overlaps it beyond the threshold. Returns the
    keep mask (..., k)."""
    k = boxes.shape[-2]
    over = _iou_matrix(boxes) > _thresh(iou_thresh, boxes)
    order = torch.arange(k, device=boxes.device)
    keep = scores > 0.0
    for i in range(k):
        suppress = keep[..., i, None] & over[..., i, :] & (order > i)
        keep = keep & ~suppress
    return keep


def nms_iterative(
    boxes: torch.Tensor,   # (..., k, 4) sorted by descending score
    scores: torch.Tensor,  # (..., k)
    iou_thresh: float,
) -> torch.Tensor:
    """Exact greedy NMS as a fixed-point iteration.

    Greedy NMS is the unique solution of
    ``keep_i = valid_i & !exists j<i: keep_j & iou(j,i) > t``; iterating
    ``keep <- valid & !(keep^T S > 0)`` with S the strictly-lower
    suppression matrix reaches it in at most depth-of-the-suppression-DAG
    steps. Keep masks are bit-identical to :func:`nms_padded`."""
    k = boxes.shape[-2]
    order = torch.arange(k, device=boxes.device)
    supp = ((_iou_matrix(boxes) > _thresh(iou_thresh, boxes))
            & (order[:, None] < order[None, :])).to(torch.float32)
    valid = scores > 0.0

    def step(cur):
        sup = (cur.to(torch.float32)[..., None, :] @ supp)[..., 0, :]
        return valid & ~(sup > 0.0)

    prev, cur, it = valid, step(valid), 1
    while it < k and bool((prev != cur).any()):
        prev, cur, it = cur, step(cur), it + 1
    return cur
