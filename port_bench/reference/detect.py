"""Plain detection post-processing: anchors, per-anchor best class,
top-k on logits, sigmoid, decode, clip and class-aware greedy NMS.

The benchmark's own float32 version of what a RetinaNet predict returns
(Lin et al. 2017, section 5.1: top-1k candidates, threshold 0.05, NMS at
0.5, the best 300 kept per image), with the program's documented choices:
one label per anchor (its best class), the k candidates ranked by that
class's logit with ties to the lower anchor index, boxes decoded with
the deltas scaled by ``bbox_std``, clipped to the frame, NMS made
class-aware by offsetting each class into its own coordinate range.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

RATIOS = (0.5, 1.0, 2.0)
SCALES = (1.0, 2.0 ** (1.0 / 3.0), 2.0 ** (2.0 / 3.0))


def anchors(height: int, width: int, levels: Sequence[int] = (3, 4, 5, 6, 7)) -> np.ndarray:
    """(N, 4) xyxy float32: level-major, cell row-major, ratio-major and
    scale-minor; cell centres at (i + 0.5) * 2**l, base size 2**(l + 2),
    feature maps of ceil(size / 2**l)."""
    out = []
    for lv in levels:
        stride, base = 2 ** lv, 2.0 ** (lv + 2)
        fh, fw = -(-height // stride), -(-width // stride)
        side = np.array([base * s for _ in RATIOS for s in SCALES])
        r = np.repeat(np.array(RATIOS), len(SCALES))
        w = np.sqrt(side * side / r)
        h = w * r
        cell = np.stack([-w / 2, -h / 2, w / 2, h / 2], 1).astype(np.float32)
        cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
        cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
        gx, gy = np.meshgrid(cx, cy)
        centre = np.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
        out.append((centre + cell[None]).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def decode(anc: torch.Tensor, deltas: torch.Tensor, std=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    w = anc[..., 2] - anc[..., 0]
    h = anc[..., 3] - anc[..., 1]
    cx = anc[..., 0] + 0.5 * w
    cy = anc[..., 1] + 0.5 * h
    pcx = cx + deltas[..., 0] * std[0] * w
    pcy = cy + deltas[..., 1] * std[1] * h
    pw = torch.exp(deltas[..., 2] * std[2]) * w
    ph = torch.exp(deltas[..., 3] * std[3]) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


def iou_matrix(b: torch.Tensor) -> torch.Tensor:
    """(..., k, 4) -> (..., k, k) IoU, union floored at 1e-8."""
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    inter = iw * ih
    return inter / (area[..., :, None] + area[..., None, :] - inter).clamp(min=1e-8)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou: float) -> torch.Tensor:
    """Greedy hard NMS over score-sorted (B, k, 4) boxes, one candidate at
    a time: a box is kept unless a kept box before it overlaps it by more
    than ``iou``; zero scores are never kept. Returns (B, k) bool."""
    k = boxes.shape[1]
    over = iou_matrix(boxes) > iou
    keep = scores > 0
    later = torch.arange(k, device=boxes.device)
    for i in range(k):
        keep = keep & ~(keep[:, i, None] & over[:, i, :] & (later > i))
    return keep


def detect(logits: torch.Tensor, deltas: torch.Tensor, anc: torch.Tensor, height: int,
           width: int, score_thresh: float = 0.05, iou: float = 0.5, topk: int = 1024,
           max_det: int = 300, bbox_std=(0.1, 0.1, 0.2, 0.2)) -> Dict[str, torch.Tensor]:
    """(B, N, C) logits and (B, N, 4) deltas -> boxes (B, D, 4), scores,
    labels and valid (B, D), D = ``max_det``, sorted by score."""
    best, label = logits.max(dim=-1)
    k = min(topk, best.shape[1])
    top, idx = torch.sort(best, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    score = torch.sigmoid(top)
    score = torch.where(score > score_thresh, score, torch.zeros_like(score))
    label = torch.gather(label, 1, idx)
    box = decode(anc[idx], torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4)), bbox_std)
    box = torch.stack([box[..., 0].clamp(min=0), box[..., 1].clamp(min=0),
                       box[..., 2].clamp(max=width), box[..., 3].clamp(max=height)], -1)
    span = box.amax(dim=(1, 2), keepdim=True) + 1.0
    keep = greedy_nms(box + label[..., None].float() * span, score, iou)
    kept = torch.where(keep, score, torch.zeros_like(score))
    d = min(max_det, k)
    out, order = torch.sort(kept, dim=1, descending=True, stable=True)
    out, order = out[:, :d], order[:, :d]
    return {"boxes": torch.gather(box, 1, order[..., None].expand(-1, -1, 4)),
            "scores": out, "labels": torch.gather(label, 1, order),
            "valid": out > score_thresh}
