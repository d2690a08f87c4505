"""IL loss composition (the JAX package's ``il/losses.py``).

    total, metrics = compute_losses(model, images, gt_boxes, gt_labels, ...)

specialized by a frozen :class:`LossStatics`. The metric keys are the
JAX package's (``cls_bg_loss``, ``cls_fg_loss``, ``reg_loss``,
``dist_cls_loss``, ``dist_reg_loss``, ``dist_feat_loss``, ``sim_loss``,
``enhance_loss``, ``enhance_on_new_loss``, ``prototype_loss``,
``total_loss``), so records line up.

  * plain path (state 0, replay batches, the classifier warm stage, the
    final correction): the focal loss on activated scores; on replay
    batches the per-image fg losses below ``clip_replay_cls_loss`` drop
    out of the mean; ``enhance_error`` on replay batches (mean |p|^k over
    new-class scores > 0.05); under ``enhance_only`` that term is the
    whole objective;
  * incremental path (states >= 1): the focal loss on sigmoid(logits)
    with every IL flag, the per-image fg losses below ``clip_cls_loss``
    dropped; distillation from the frozen teacher (its forward under
    ``torch.no_grad``): the cosine feature loss summed over the five FPN
    maps (per map, the mean over its B*H*W vectors of 1 - cos, the
    vectors along the channel dim of the NCHW maps), smooth-L1 (beta 1)
    regression distillation on the anchors that are not positive for
    the student and foreground for the teacher, and the MSE
    classification distillation on the teacher's foreground entries (on
    every old-class column of those anchors under ``ignore_gd``), on
    logits or probabilities per ``distill_logits``; the cosine-margin
    classifier-similarity loss against the teacher's class vectors;
    under ``use_pseudo_progress`` the focal loss discounts old-class
    false positives on pseudo-labelled anchors by ``pseudo_progress``;
    under ``use_prototype`` the student's forward also gives the
    3x3-unfolded classification-trunk features, and the prototype term
    (``il/prototype.prototype_loss_from_batch``) pushes the batch's
    new-class prototypes away from the stored old ones;
  * on both paths, under ``use_mas`` with the importance and the previous
    parameters given, the MAS penalty ``mas_loss``
    (``ratio * sum(importance * (theta - theta_prev)^2)``);
  * ``bic_correct`` (a logits -> logits callable, the BiC correction):
    on the plain path the logits are taken without the activation and
    the scores are ``sigmoid(bic_correct(logits))``; on the incremental
    path the logits are corrected before the sigmoid.

On the mesh's data axis (``mesh=``, W = ``num_data`` > 1 ranks in each
data group, each holding its slice of the global batch; the ranks of a
model group hold the same slice) every term is this rank's share of the
GLOBAL batch's, so that the mean over the data group of the terms, and of
their gradients, is the global batch's, as under JAX's mesh:
  * per-image means (``fg``, ``bg``, ``reg``, the cosine feature loss, a
    mean over B*H*W) average correctly over equal slices as they stand;
  * terms normalised by a count over the batch (``_masked_mean``:
    ``enhance_error``, ``dist_cls_loss``; ``_clip_fg_mean``;
    ``dist_reg_loss``) are W * (local sum) / (global count), the count
    all-reduced without a gradient;
  * the focal loss's ``enhance_on_new`` term, a sum over the batch, is W *
    (local sum);
  * the prototype term takes the global class sums and counts and keeps
    the gradient of this rank's share (``parallel.mesh.batch_global``);
  * terms of the parameters alone (``mas_loss``, ``sim_loss``) stay as
    they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..config import FocalConfig, ILConfig
from ..ops.focal_loss import focal_loss
from ..parallel.mesh import DataMesh, all_reduce_sum, data_active
from ..utils.profiling import span
from .prototype import prototype_loss_from_batch


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


def _global_ratio(total: torch.Tensor, cnt: torch.Tensor, mesh: Optional[DataMesh]):
    """(numerator, count) of a batch-normalised term: on the mesh's data
    axis, W * the local sum and the global count (no gradient through it),
    W the data axis's size and the count summed over the data group."""
    if not data_active(mesh):
        return total, cnt
    return total * mesh.num_data, all_reduce_sum(mesh, cnt)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 mesh: Optional[DataMesh] = None) -> torch.Tensor:
    total, cnt = _global_ratio(torch.where(mask, values, 0.0).sum(), mask.float().sum(), mesh)
    return total / torch.clamp(cnt, min=1.0)


def _enhance_error(cls: torch.Tensor, s: LossStatics,
                   mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """New-class score penalty on replay images: sum(|p|^k over entries
    > 0.05) / max(count, 1), k per L1/L2/L3."""
    pn = cls[:, :, s.num_past_class:]
    mask = pn > 0.05
    k = {"L1": 1, "L2": 2, "L3": 3}[s.enhance_error_method.upper()]
    return _masked_mean(torch.abs(pn) ** k, mask, mesh)


def _clip_fg_mean(fg_per_image: torch.Tensor, threshold: float,
                  mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Mean of the per-image fg losses >= threshold; 0 if none survive."""
    mask = fg_per_image >= threshold
    total, cnt = _global_ratio(torch.where(mask, fg_per_image, 0.0).sum(),
                               mask.float().sum(), mesh)
    mean = total / torch.clamp(cnt, min=1.0)
    return torch.where(cnt > 0, mean, 0.0)


def _smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ad = torch.abs(diff)
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def _safe_norm(x: torch.Tensor, dim=None, eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum(x^2) + eps): a plain norm has a NaN gradient at a zero
    vector (all-ReLU-dead FPN rows in padded regions give them). A sum of
    squares, as JAX's, not ``torch.linalg.vector_norm`` (off by ~4e-5
    relative on the CPU at millions of elements)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def _cosine_feat_loss(feat_s: Sequence[torch.Tensor],
                      feat_t: Sequence[torch.Tensor]) -> torch.Tensor:
    """Cosine-embedding loss (target 1) summed over the FPN levels: per
    NCHW map, the mean over its B*H*W vectors (taken along dim 1, the
    channels) of 1 - cos(student, teacher)."""
    total = 0.0
    for fs, ft in zip(feat_s, feat_t):
        fs, ft = fs.float(), ft.float()
        num = torch.sum(fs * ft, dim=1)
        den = _safe_norm(fs, dim=1) * _safe_norm(ft, dim=1)
        cos = num / torch.maximum(den, den.new_full((), 1e-8))
        total = total + torch.mean(1.0 - cos)
    return total


def mas_penalty(params: Mapping[str, torch.Tensor], prev_params: Mapping[str, torch.Tensor],
                importance: Mapping[str, torch.Tensor], ratio: float) -> torch.Tensor:
    """The MAS regularizer ``ratio * sum(importance * (theta - theta_prev)^2)``
    over the parameters by name, in float32. A leaf without an importance
    or a previous value, or whose shape differs from the previous one (the
    expanded classification output), contributes 0."""
    total = 0.0
    for name, p in params.items():
        om, pp = importance.get(name), prev_params.get(name)
        if om is None or pp is None or p.shape != pp.shape:
            continue
        total = total + torch.sum(om * (p.float() - pp.float()) ** 2)
    return ratio * total


def classifier_vectors(weight: torch.Tensor, num_anchors: int = 9) -> torch.Tensor:
    """Per-class flattened classifier weights ``(C, A*kh*kw*cin)`` of the
    OIHW classification output weight (output channel a*C + c), in the
    JAX package's order, as a differentiable function of ``weight``
    (the twin of ``models.expand.classifier_class_vectors``)."""
    total, cin, kh, kw = weight.shape
    c = total // num_anchors
    return (weight.float().reshape(num_anchors, c, cin, kh, kw)
            .permute(1, 0, 3, 4, 2).reshape(c, -1))


def classifier_similarity_loss(new_class_vectors: torch.Tensor,
                               past_class_vectors: torch.Tensor,
                               delta: float = 0.5) -> torch.Tensor:
    """Cosine-margin penalty pushing the new classes' filters away from
    the old ones: the sum over new classes j and old classes i of
    max(|cos(w_j, w_i)| - delta, 0)."""
    pn = _safe_norm(past_class_vectors, dim=1)
    total = 0.0
    for w in new_class_vectors:
        den = pn * _safe_norm(w)
        cos = past_class_vectors @ w / torch.maximum(den, den.new_full((), 1e-12))
        excess = torch.abs(cos) - delta
        total = total + torch.sum(torch.maximum(excess, excess.new_zeros(())))
    return total


def compute_losses(
    model,                             # the RetinaNet: model(images, enable_act), .forward_all
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    anchors: torch.Tensor,
    il_cfg: ILConfig,
    focal_cfg: FocalConfig,
    statics: LossStatics,
    *,
    teacher=None,                      # the frozen previous-state RetinaNet
    classifier_vectors: Optional[torch.Tensor] = None,  # the teacher's (C_old, D)
    pseudo_progress: Optional[torch.Tensor] = None,     # () cur_epoch / end_epoch
    prototype_features: Optional[torch.Tensor] = None,  # (C_old, D), slot-averaged
    bic_correct: Optional[Callable] = None,             # logits -> corrected logits
    mas_prev_params: Optional[Mapping[str, torch.Tensor]] = None,
    mas_importance: Optional[Mapping[str, torch.Tensor]] = None,
    mesh: Optional[DataMesh] = None,   # the data axis: this rank's share
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics); see the module docstring."""
    s = statics
    if s.incremental:
        result = _incremental_losses(model, images, gt_boxes, gt_labels, anchors, il_cfg,
                                     focal_cfg, s, teacher, classifier_vectors,
                                     pseudo_progress, prototype_features, bic_correct, mesh)
    else:
        result = _plain_losses(model, images, gt_boxes, gt_labels, anchors, il_cfg,
                               focal_cfg, s, bic_correct, mesh)
        if s.enhance_only:
            total = result["enhance_loss"]
            return total, {**result, "total_loss": total}
    if s.use_mas and mas_importance is not None and mas_prev_params is not None:
        result["mas_loss"] = mas_penalty(dict(model.named_parameters()), mas_prev_params,
                                         mas_importance, il_cfg.mas.ratio)
    total = sum(result.values())
    return total, {**result, "total_loss": total}


def _plain_losses(model, images, gt_boxes, gt_labels, anchors, il_cfg: ILConfig,
                  focal_cfg: FocalConfig, s: LossStatics,
                  bic_correct, mesh) -> Dict[str, torch.Tensor]:
    """The loss terms of the plain path, in the JAX package's order."""
    result: Dict[str, torch.Tensor] = {}
    if bic_correct is not None:
        logits, regression = model(images, enable_act=False)
        cls = torch.sigmoid(bic_correct(logits))
    else:
        cls, regression = model(images, enable_act=True)
    if s.enhance_only:
        result["enhance_loss"] = _enhance_error(cls, s, mesh)
        return result

    out = focal_loss(
        cls, regression, anchors, gt_boxes, gt_labels,
        alpha=focal_cfg.alpha, gamma=focal_cfg.gamma,
        fg_iou=focal_cfg.fg_iou, bg_iou=focal_cfg.bg_iou,
        bbox_std=tuple(focal_cfg.bbox_std),
    )
    if il_cfg.clip_loss and s.is_replay:
        result["cls_fg_loss"] = _clip_fg_mean(out.fg_loss, il_cfg.clip_replay_cls_loss, mesh)
    else:
        result["cls_fg_loss"] = out.fg_loss.mean()
    result["cls_bg_loss"] = out.bg_loss.mean()
    result["reg_loss"] = out.reg_loss.mean()
    if s.use_enhance_error and s.is_replay and not s.is_bic:
        result["enhance_loss"] = _enhance_error(cls, s, mesh)
    return result


def _incremental_losses(model, images, gt_boxes, gt_labels, anchors, il_cfg: ILConfig,
                        focal_cfg: FocalConfig, s: LossStatics, teacher,
                        class_vectors, pseudo_progress,
                        prototype_features, bic_correct, mesh) -> Dict[str, torch.Tensor]:
    """The loss terms of the incremental path, in the JAX package's order."""
    result: Dict[str, torch.Tensor] = {}
    use_prototype = s.use_prototype and prototype_features is not None
    if use_prototype:
        logits, regression, feats, unfolded = model.classification_features(images, False)
    else:
        logits, regression, feats = model.forward_all(images, False)
    if bic_correct is not None:
        logits = bic_correct(logits)
    cls = torch.sigmoid(logits)
    out = focal_loss(
        cls, regression, anchors, gt_boxes, gt_labels,
        alpha=focal_cfg.alpha, gamma=focal_cfg.gamma,
        num_past_class=s.num_past_class, incremental=True,
        ignore_past_class=il_cfg.ignore_past_class,
        new_ignore_past_class=il_cfg.new_ignore_past_class,
        decrease_positive=il_cfg.decrease_positive,
        decrease_positive_by_iou=il_cfg.decrease_positive_by_iou,
        enhance_on_new=s.use_enhance_on_new,
        pseudo_progress=pseudo_progress if s.use_pseudo_progress else None,
        fg_iou=focal_cfg.fg_iou, bg_iou=focal_cfg.bg_iou,
        bbox_std=tuple(focal_cfg.bbox_std),
    )
    if il_cfg.clip_loss:
        result["cls_fg_loss"] = _clip_fg_mean(out.fg_loss, il_cfg.clip_cls_loss, mesh)
    else:
        result["cls_fg_loss"] = out.fg_loss.mean()
    result["cls_bg_loss"] = out.bg_loss.mean()
    result["reg_loss"] = out.reg_loss.mean()
    if s.use_enhance_on_new:
        e = out.enhance_on_new_loss        # a sum over the batch
        result["enhance_on_new_loss"] = e * mesh.num_data if data_active(mesh) else e
    if use_prototype:
        result["prototype_loss"] = prototype_loss_from_batch(
            unfolded, ~out.bg_mask, out.pos_label, prototype_features,
            num_past_class=s.num_past_class, num_new_class=s.num_classes - s.num_past_class,
            margin=il_cfg.prototype.margin, weight=il_cfg.prototype.weight, mesh=mesh)
    if not s.use_distill:
        return result
    if teacher is None:
        raise ValueError("distillation needs the teacher model")

    with torch.no_grad(), span("cldet.train.teacher"):
        t_logits, t_reg, t_feats = teacher.forward_all(images, False)
    result["dist_feat_loss"] = _cosine_feat_loss(feats, t_feats)

    s_old = logits[:, :, :s.num_past_class]
    t_prob = torch.sigmoid(t_logits)
    if s.distill_logits:
        s_cmp, t_cmp = s_old, t_logits
    else:
        s_cmp, t_cmp = torch.sigmoid(s_old), t_prob
    t_fg = t_prob > 0.05                                    # (B, A, C_old)
    reg_mask = out.bg_mask & t_fg.any(dim=2)                # (B, A)
    reg_diff = _smooth_l1(t_reg - regression, beta=1.0)
    reg_sum, reg_cnt = _global_ratio(torch.where(reg_mask[..., None], reg_diff, 0.0).sum(),
                                     reg_mask.float().sum(), mesh)
    result["dist_reg_loss"] = reg_sum / torch.clamp(reg_cnt * 4.0, min=1.0)
    # ignore_gd: every old-class column of the reg_mask anchors;
    # otherwise the teacher's foreground entries only
    cls_mask = reg_mask[..., None].expand(t_fg.shape) if s.ignore_gd else t_fg
    result["dist_cls_loss"] = _masked_mean((t_cmp - s_cmp) ** 2, cls_mask, mesh)

    if s.use_classifier_loss and class_vectors is not None:
        # the student's new-class filters against the teacher's (C_old, D)
        weight = model.classification_head.output.weight
        cur = classifier_vectors(weight, weight.shape[0] // s.num_classes)
        result["sim_loss"] = classifier_similarity_loss(
            cur[s.num_past_class:], class_vectors, il_cfg.classifier_loss_delta)
    return result
