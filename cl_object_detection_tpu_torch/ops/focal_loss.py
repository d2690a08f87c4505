"""Focal + smooth-L1 detection loss with every IL variant (the JAX
package's ``ops/focal_loss.py``), batched over images with -1-padded GT.

  * IoU bands: bg < ``bg_iou``, ignore [bg_iou, fg_iou), fg >= ``fg_iou``;
  * the has-GT path weighs fg and bg entries by a constant ``alpha``; an
    image without GT is all background, weighed by ``1 - alpha``, with
    no ignore band;
  * bg and fg losses come back separately per image, each over
    max(num_pos, 1);
  * regression: smooth-L1 (beta 1/9) on the std-normalized targets of
    ``encode_boxes``, mean over positive anchors x 4 coords;
  * IL variants: ``ignore_past_class``, ``new_ignore_past_class``,
    ``decrease_positive``, ``decrease_positive_by_iou``,
    ``enhance_on_new`` and the pseudo-label ``pseudo_progress`` discount.

The best GT of an anchor is the first maximum of its IoU row, gathered
exactly (``torch.argmax`` returns the first maximal index). JAX builds
the same assignment from a first-max one-hot and matmuls at HIGHEST
precision; a matmul here would round in TF32 on the card.

Clips go through ``torch.maximum`` / ``torch.minimum``, which split the
gradient 0.5 / 0.5 at a tie as ``jnp.clip`` does (``torch.clamp`` would
pass all of it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .boxes import encode_boxes, pairwise_iou


class FocalLossOutput(NamedTuple):
    bg_loss: torch.Tensor             # (B,) background cls loss per image
    fg_loss: torch.Tensor             # (B,) foreground cls loss per image
    reg_loss: torch.Tensor            # (B,) regression loss per image
    num_pos: torch.Tensor             # (B,) positive anchor counts
    bg_mask: torch.Tensor             # (B, A) bool: NOT positive
    enhance_on_new_loss: torch.Tensor  # () scalar
    pos_label: torch.Tensor           # (B, A) int32 label on positives, -1 else


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum, then minimum, with their tie gradients."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def focal_loss(
    cls_prob: torch.Tensor,       # (B, A, C) probabilities in (0, 1)
    regression: torch.Tensor,     # (B, A, 4)
    anchors: torch.Tensor,        # (A, 4) xyxy
    gt_boxes: torch.Tensor,       # (B, M, 4) xyxy, -1 padded
    gt_labels: torch.Tensor,      # (B, M) int, -1 padded
    *,
    alpha: float = 0.25,
    gamma: float = 2.0,
    num_past_class: int = 0,
    incremental: bool = False,
    ignore_past_class: bool = False,
    new_ignore_past_class: bool = False,
    decrease_positive: float = 1.0,
    decrease_positive_by_iou: bool = False,
    enhance_on_new: bool = False,
    pseudo_progress: Optional[torch.Tensor] = None,
    fg_iou: float = 0.5,
    bg_iou: float = 0.4,
    bbox_std=(0.1, 0.1, 0.2, 0.2),
) -> FocalLossOutput:
    num_classes = cls_prob.shape[-1]
    p = _clip(cls_prob.float(), 1e-4, 1.0 - 1e-4)                 # (B, A, C)
    reg = regression.float()
    anchors = anchors.float()
    valid = gt_labels >= 0                                        # (B, M)
    has_gt = valid.any(dim=1)                                     # (B,)
    hg = has_gt[:, None, None]

    iou = torch.stack([pairwise_iou(anchors, b) for b in gt_boxes.float()])  # (B, A, M)
    iou = torch.where(valid[:, None, :], iou, -1.0)
    iou_max, best = iou.max(dim=2)                                # first maximum
    assigned_label = torch.gather(gt_labels.long(), 1, best)      # (B, A)
    assigned_box = torch.gather(
        gt_boxes.float(), 1, best[..., None].expand(-1, -1, 4))   # (B, A, 4)

    bg = iou_max < bg_iou
    pos = iou_max >= fg_iou
    num_pos = pos.float().sum(dim=1)

    cols = torch.arange(num_classes, device=p.device)
    onehot = assigned_label[..., None] == cols                    # (B, A, C)

    # targets: -1 ignore, 0 negative, 1 positive
    t = torch.full_like(p, -1.0)
    if incremental and ignore_past_class:
        t = torch.where(bg[..., None] & (cols >= num_past_class), 0.0, t)
        if new_ignore_past_class:
            old_prod = p[..., :num_past_class].sum(dim=2)
            gate = (bg & (old_prod < 0.5))[..., None] & (cols < num_past_class)
            t = torch.where(gate, 0.0, t)
    else:
        t = torch.where(bg[..., None], 0.0, t)
    t = torch.where(pos[..., None], onehot.float(), t)
    t = torch.where(hg, t, 0.0)            # empty-GT image: all background

    is_one = t == 1.0
    if incremental and decrease_positive_by_iou:
        fw = torch.where(is_one, 1.0 - p, p)
        mid_target = ((iou_max <= 0.7) & pos)[..., None] & onehot
        upper = _clip(iou_max + 0.2, 1e-4, 1.0 - 1e-4)[..., None]
        fw = torch.where(mid_target,
                         torch.where(p >= upper, 1e-4, torch.abs(p - upper)), fw)
    elif incremental:
        dp = decrease_positive
        fw = torch.where(is_one, dp - _clip(p, 0.0, dp), p)
    else:
        fw = torch.where(is_one, 1.0 - p, p)

    alpha_eff = torch.where(hg, alpha, 1.0 - alpha)
    fw = alpha_eff * (fw * fw if gamma == 2.0 else torch.pow(fw, gamma))
    # t is exactly 0 or 1 wherever the loss counts, so the two-log BCE is
    # one log of the selected probability
    bce = -torch.log(torch.where(is_one, p, 1.0 - p))
    cls_loss = torch.where(t != -1.0, fw * bce, 0.0)

    if incremental and pseudo_progress is not None:
        fake_anchor = (t[..., num_past_class:] == 1.0).any(dim=2)
        gate = fake_anchor[..., None] & (cols < num_past_class) & (p > 0.05)
        prog = torch.as_tensor(pseudo_progress, dtype=torch.float32, device=p.device)
        scale = torch.where((prog >= 0) & gate, torch.clamp(prog, min=0.0), 1.0)
        cls_loss = cls_loss * scale

    norm = torch.clamp(num_pos, min=1.0)
    bg_loss = torch.where(t == 0.0, cls_loss, 0.0).sum(dim=(1, 2)) / torch.where(
        has_gt, norm, 1.0)
    fg_loss = torch.where(t == 1.0, cls_loss, 0.0).sum(dim=(1, 2)) / norm
    fg_loss = torch.where(has_gt, fg_loss, 0.0)

    if incremental and enhance_on_new:
        pn = p[..., num_past_class:]
        e = torch.where(bg[..., None] & (pn > 0.05), pn * pn, 0.0).sum(dim=(1, 2))
        e = torch.where(has_gt, e, 0.0).sum()
    else:
        e = p.new_zeros(())

    reg_t = encode_boxes(anchors, assigned_box, std=bbox_std)
    diff = torch.abs(reg_t - reg)
    beta = 1.0 / 9.0
    sl1 = torch.where(diff <= beta, 0.5 * 9.0 * diff * diff, diff - 0.5 * beta)
    reg_loss = torch.where(pos[..., None], sl1, 0.0).sum(dim=(1, 2)) / (norm * 4.0)
    reg_loss = torch.where((num_pos > 0) & has_gt, reg_loss, 0.0)

    pos_label = torch.where(pos & has_gt[:, None], assigned_label, -1).to(torch.int32)
    return FocalLossOutput(bg_loss, fg_loss, reg_loss, num_pos, ~pos, e, pos_label)
