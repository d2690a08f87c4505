"""Box math on tensors: pairwise IoU, delta decode and clip (the JAX
package's ``ops/boxes.py``)."""
from __future__ import annotations

from typing import Sequence

import torch

BBOX_STD = (0.1, 0.1, 0.2, 0.2)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU matrix (N, M) between xyxy boxes: intersection width and height
    clamped at 0, union clamped at a 1e-8 floor."""
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    iw = torch.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2]) - torch.maximum(
        boxes_a[:, None, 0], boxes_b[None, :, 0])
    ih = torch.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3]) - torch.maximum(
        boxes_a[:, None, 1], boxes_b[None, :, 1])
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    union = (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-8)
    return inter / union


def _center_form(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return cx, cy, w, h


def decode_boxes(
    anchors: torch.Tensor,
    deltas: torch.Tensor,
    std: Sequence[float] = BBOX_STD,
    mean: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
) -> torch.Tensor:
    """(dx, dy, dw, dh) * std + mean against the anchors -> xyxy boxes."""
    acx, acy, aw, ah = _center_form(anchors)
    # python scalars, not a device tensor: a host-to-device copy would
    # wait for the stream
    d = [deltas[..., i] * float(std[i]) + float(mean[i]) for i in range(4)]
    pcx = acx + d[0] * aw
    pcy = acy + d[1] * ah
    pw = torch.exp(d[2]) * aw
    ph = torch.exp(d[3]) * ah
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x1, y1 >= 0; x2 <= width; y2 <= height."""
    return torch.stack([
        boxes[..., 0].clamp(min=0),
        boxes[..., 1].clamp(min=0),
        boxes[..., 2].clamp(max=width),
        boxes[..., 3].clamp(max=height),
    ], dim=-1)
