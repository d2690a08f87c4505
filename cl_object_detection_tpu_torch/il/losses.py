"""IL loss composition (the JAX package's ``il/losses.py``).

    total, metrics = compute_losses(model, images, gt_boxes, gt_labels, ...)

specialized by a frozen :class:`LossStatics`. The metric keys are the
JAX package's (``cls_bg_loss``, ``cls_fg_loss``, ``reg_loss``,
``enhance_loss``, ``total_loss``), so records line up.

This slice carries the plain path (state 0, replay batches, the
classifier warm stage, the final correction):
  * the focal loss on activated scores; on replay batches the per-image
    fg losses below ``clip_replay_cls_loss`` drop out of the mean;
  * ``enhance_error`` on replay batches: mean |p|^k over new-class
    scores > 0.05;
  * ``enhance_only``: the enhance_error term is the whole objective.

The incremental path (distillation, prototypes, classifier similarity)
and the MAS penalty raise ``NotImplementedError``: they are ROADMAP §1
item 4.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..config import FocalConfig, ILConfig
from ..ops.focal_loss import focal_loss

INCREMENTAL_NOT_PORTED = ("the incremental loss terms (distillation, prototypes, "
                          "classifier similarity, MAS) are not ported yet: ROADMAP §1 item 4")


@dataclass(frozen=True)
class LossStatics:
    """Static description of the current (state, batch) kind."""
    num_classes: int
    num_past_class: int = 0
    incremental: bool = False          # cur_state>0 ∧ ¬replay ∧ ¬warm-cls
    is_replay: bool = False
    is_bic: bool = False
    use_distill: bool = False
    distill_logits: bool = False
    use_pseudo_progress: bool = False
    use_enhance_error: bool = False
    enhance_error_method: str = "L2"
    use_enhance_on_new: bool = False
    use_classifier_loss: bool = False
    use_mas: bool = False
    use_prototype: bool = False
    ignore_gd: bool = False
    enhance_only: bool = False         # final-correction objective: only
                                       # the enhance_error term


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    cnt = mask.float().sum()
    return torch.where(mask, values, 0.0).sum() / torch.clamp(cnt, min=1.0)


def _enhance_error(cls: torch.Tensor, s: LossStatics) -> torch.Tensor:
    """New-class score penalty on replay images: sum(|p|^k over entries
    > 0.05) / max(count, 1), k per L1/L2/L3."""
    pn = cls[:, :, s.num_past_class:]
    mask = pn > 0.05
    k = {"L1": 1, "L2": 2, "L3": 3}[s.enhance_error_method.upper()]
    return _masked_mean(torch.abs(pn) ** k, mask)


def _clip_fg_mean(fg_per_image: torch.Tensor, threshold: float) -> torch.Tensor:
    """Mean of the per-image fg losses >= threshold; 0 if none survive."""
    mask = fg_per_image >= threshold
    cnt = mask.float().sum()
    mean = torch.where(mask, fg_per_image, 0.0).sum() / torch.clamp(cnt, min=1.0)
    return torch.where(cnt > 0, mean, 0.0)


def _smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ad = torch.abs(diff)
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def compute_losses(
    model,                             # the RetinaNet: model(images, enable_act)
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    anchors: torch.Tensor,
    il_cfg: ILConfig,
    focal_cfg: FocalConfig,
    statics: LossStatics,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics) of the plain path; see the module docstring."""
    s = statics
    if s.incremental or s.use_mas:
        raise NotImplementedError(INCREMENTAL_NOT_PORTED)
    result: Dict[str, torch.Tensor] = {}
    cls, regression = model(images, enable_act=True)

    if s.enhance_only:
        total = result["enhance_loss"] = _enhance_error(cls, s)
        return total, {**result, "total_loss": total}

    out = focal_loss(
        cls, regression, anchors, gt_boxes, gt_labels,
        alpha=focal_cfg.alpha, gamma=focal_cfg.gamma,
        fg_iou=focal_cfg.fg_iou, bg_iou=focal_cfg.bg_iou,
        bbox_std=tuple(focal_cfg.bbox_std),
    )
    if il_cfg.clip_loss and s.is_replay:
        result["cls_fg_loss"] = _clip_fg_mean(out.fg_loss, il_cfg.clip_replay_cls_loss)
    else:
        result["cls_fg_loss"] = out.fg_loss.mean()
    result["cls_bg_loss"] = out.bg_loss.mean()
    result["reg_loss"] = out.reg_loss.mean()
    if s.use_enhance_error and s.is_replay and not s.is_bic:
        result["enhance_loss"] = _enhance_error(cls, s)

    total = sum(result.values())
    return total, {**result, "total_loss": total}
