"""Plain float32 incremental-state train steps of a RetinaNet with
distillation from a frozen teacher, followed by clip and Adam.

The benchmark's own reference of the objective the program trains at a
state >= 1 (the focal loss of Lin et al. 2017 with the smooth-L1 box
loss, plus the frozen teacher's distillation terms) with its documented
constants:

* anchor assignment: IoU >= 0.5 positive, < 0.4 background, the band
  between ignored; an anchor's box and label are those of its first
  best ground truth; padded ground truth (label -1) never matches;
* focal loss on the sigmoid of the logits, clipped to [1e-4, 1 - 1e-4],
  alpha 0.25, gamma 2, per image over max(positives, 1): the background
  and foreground sums apart; the batch's foreground loss is the mean of
  the per-image losses of at least ``clip_cls`` (0 when none is);
* box loss: smooth L1 (beta 1/9) on the deltas to the assigned box
  divided by (0.1, 0.1, 0.2, 0.2), over 4 x max(positives, 1);
* distillation: the cosine feature loss summed over P3..P7 (the mean of
  1 - cos over every pixel), the smooth-L1 (beta 1) box term on anchors
  that are not positive and where some old-class teacher probability
  passes 0.05 (over 4 x their count), and the squared gap of the old
  classes' probabilities on the teacher's foreground entries;
* every ``every_iter`` micro-steps the summed gradient is divided by
  ``every_iter``, scaled to a global norm of at most ``clip`` (``min(1,
  clip / max(norm, 1e-6))``) and given to Adam (bias-corrected, eps
  outside the root).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .retinanet import Net, Params


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-8)


def encode(anc: torch.Tensor, gt: torch.Tensor, std=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    aw, ah = anc[..., 2] - anc[..., 0], anc[..., 3] - anc[..., 1]
    acx, acy = anc[..., 0] + 0.5 * aw, anc[..., 1] + 0.5 * ah
    gw, gh = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    gcx, gcy = gt[..., 0] + 0.5 * gw, gt[..., 1] + 0.5 * gh
    gw, gh = gw.clamp(min=1.0), gh.clamp(min=1.0)
    t = [(gcx - acx) / aw, (gcy - acy) / ah, torch.log(gw / aw), torch.log(gh / ah)]
    return torch.stack([t[i] / std[i] for i in range(4)], -1)


def smooth_l1(d: torch.Tensor, beta: float) -> torch.Tensor:
    d = d.abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def detection_losses(logits, reg, anc, boxes, labels, alpha=0.25, fg_iou=0.5, bg_iou=0.4,
                     clip_cls=0.03):
    """(foreground, background, box) losses of the batch and the (B, N)
    not-positive mask."""
    p = torch.sigmoid(logits).clamp(1e-4, 1 - 1e-4)
    valid = labels >= 0
    has_gt = valid.any(dim=1)
    iou = torch.stack([pairwise_iou(anc, b) for b in boxes])
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best = iou.max(dim=2)
    lab = torch.gather(labels, 1, best)
    box = torch.gather(boxes, 1, best[..., None].expand(-1, -1, 4))
    pos, bg = best_iou >= fg_iou, best_iou < bg_iou
    npos = pos.sum(dim=1).float()
    norm = npos.clamp(min=1.0)
    onehot = lab[..., None] == torch.arange(p.shape[-1], device=p.device)
    target = torch.where(bg[..., None], 0.0, -1.0) * torch.ones_like(p)
    target = torch.where(pos[..., None], onehot.float(), target)
    target = torch.where(has_gt[:, None, None], target, torch.zeros_like(target))
    one = target == 1.0
    w = torch.where(has_gt, alpha, 1.0 - alpha)[:, None, None] * torch.where(one, 1 - p, p) ** 2
    ce = -torch.log(torch.where(one, p, 1 - p))
    loss = torch.where(target >= 0, w * ce, torch.zeros_like(ce))
    bg_img = torch.where(target == 0, loss, 0.0).sum(dim=(1, 2)) / torch.where(has_gt, norm, 1.0)
    fg_img = torch.where(has_gt, torch.where(one, loss, 0.0).sum(dim=(1, 2)) / norm, 0.0)
    d = encode(anc, box) - reg
    sl1 = smooth_l1(d, 1.0 / 9.0)
    reg_img = torch.where(pos[..., None], sl1, 0.0).sum(dim=(1, 2)) / (norm * 4.0)
    reg_img = torch.where((npos > 0) & has_gt, reg_img, 0.0)
    keep = fg_img >= clip_cls
    fg = torch.where(keep, fg_img, 0.0).sum() / keep.float().sum().clamp(min=1.0)
    return fg, bg_img.mean(), reg_img.mean(), ~pos


def cosine_loss(fs: Sequence[torch.Tensor], ft: Sequence[torch.Tensor]) -> torch.Tensor:
    total = 0.0
    for s, t in zip(fs, ft):
        num = (s * t).sum(dim=1)
        den = torch.sqrt((s * s).sum(dim=1) + 1e-12) * torch.sqrt((t * t).sum(dim=1) + 1e-12)
        total = total + (1.0 - num / den.clamp(min=1e-8)).mean()
    return total


TERMS = ("fg", "bg", "box", "feat", "dist_box", "dist_cls")


def state1_loss(student: Net, teacher: Net, images, boxes, labels, anc, num_past: int):
    """(total, terms) of one micro-step (module docstring): ``terms`` maps
    each of ``TERMS`` to its loss."""
    logits, reg, feats = student.forward_all(images)
    fg, bg, box, not_pos = detection_losses(logits, reg, anc, boxes, labels)
    with torch.no_grad():
        t_logits, t_reg, t_feats = teacher.forward_all(images)
    t_prob = torch.sigmoid(t_logits)
    t_fg = t_prob > 0.05
    mask = not_pos & t_fg.any(dim=2)
    dreg = torch.where(mask[..., None], smooth_l1(t_reg - reg, 1.0), 0.0).sum()
    dreg = dreg / (mask.float().sum() * 4.0).clamp(min=1.0)
    gap = (t_prob - torch.sigmoid(logits[..., :num_past])) ** 2
    dcls = torch.where(t_fg, gap, 0.0).sum() / t_fg.float().sum().clamp(min=1.0)
    terms = dict(zip(TERMS, (fg, bg, box, cosine_loss(feats, t_feats), dreg, dcls)))
    return sum(terms.values()), terms


def train(student: Params, teacher: Params, batches: List[Tuple], anc: torch.Tensor, *,
          depth: int, num_classes: int, num_past: int, micro_steps: int, every_iter: int,
          lr: float, clip: float, betas=(0.9, 0.999), eps: float = 1e-8,
          quant: Optional[object] = None, recompute: bool = False) -> Dict[str, object]:
    """Run ``micro_steps`` micro-steps from ``student`` (float32 leaves,
    copied; the frozen-BN statistics ride along unchanged) on ``batches``
    of (uint8 RGB images, boxes, labels). Returns ``losses`` (one float
    per micro-step), ``terms`` (each micro-step's ``TERMS`` as floats),
    ``grad1`` (the first apply's clipped gradient by name) and ``params``
    (the trainable leaves after the last apply).
    ``recompute``: the student's blocks recompute their activations in the
    backward (``Net``)."""
    trainable = {k for k in student if "running_" not in k}
    p = {k: v.detach().clone().requires_grad_(k in trainable) for k, v in student.items()}
    s_net = Net(p, depth, num_classes, quant=quant, recompute=recompute)
    t_net = Net(teacher, depth, num_past, quant=quant)
    mu = {k: torch.zeros_like(p[k]) for k in trainable}
    nu = {k: torch.zeros_like(p[k]) for k in trainable}
    acc = {k: torch.zeros_like(p[k]) for k in trainable}
    losses, terms, grad1, count = [], [], None, 0
    b1, b2 = betas
    for step in range(micro_steps):
        images, boxes, labels = batches[step]
        loss, parts = state1_loss(s_net, t_net, images, boxes, labels, anc, num_past)
        grads = torch.autograd.grad(loss, [p[k] for k in sorted(trainable)])
        for k, g in zip(sorted(trainable), grads):
            acc[k] += g
        losses.append(float(loss.detach()))
        terms.append({k: float(v.detach()) for k, v in parts.items()})
        if (step + 1) % every_iter:
            continue
        g = {k: acc[k] / every_iter for k in trainable}
        norm = torch.sqrt(sum((v * v).sum() for v in g.values()))
        scale = torch.clamp(clip / norm.clamp(min=1e-6), max=1.0)
        g = {k: v * scale for k, v in g.items()}
        if grad1 is None:
            grad1 = {k: v.clone() for k, v in g.items()}
        count += 1
        with torch.no_grad():
            for k in trainable:
                mu[k].mul_(b1).add_(g[k], alpha=1 - b1)
                nu[k].mul_(b2).add_(g[k] * g[k], alpha=1 - b2)
                upd = (mu[k] / (1 - b1 ** count)) / (torch.sqrt(nu[k] / (1 - b2 ** count)) + eps)
                p[k].sub_(lr * upd)
                acc[k].zero_()
    return {"losses": losses, "terms": terms, "grad1": grad1,
            "params": {k: p[k].detach() for k in trainable}}
