"""The numbers that decide ``correct``: what the timed path produced,
judged against the plain reference, and each number against its limit.

Detections (``detections``): for every sampled image, each of the
reference's ``top`` best valid detections is looked for among the
program's valid detections of the same label; the one of highest IoU
matches it when that IoU passes ``MATCH_IOU`` (the same anchor's box:
two anchors' boxes that overlap so much are of one label's NMS, which
keeps at most one of them; a box the program kept where the reference
kept a neighbour is a miss). From the pairs and the misses:

* ``miss_share``: the share of the reference's detections without a match;
* ``worst_image_miss``: the same share in the worst image;
* ``logit_gap``: the mean over matched pairs of the gap between the
  logits of the two scores (``log(s / (1 - s))``).

Train steps (``train_steps``), by the worst leaf: the gap between the
program's norm and the reference's of each leaf, over the larger of the
reference leaf's norm and the median leaf's:

* ``loss_gap``: the largest relative gap of a micro-step's loss;
* ``grad_gap``: of the first apply's gradient as the optimizer got it;
* ``change_gap``: of each leaf's change over the applies, leaving out the
  leaves whose reference gradient is under a thousandth of the median
  leaf's (under Adam they move by round-off alone).

and of each loss term that the program reports beside the total
(``<term>_loss_gap``): the largest relative gap of a micro-step's term.
The terms over the ground truth (the foreground and box losses) are
means over images that differ from image to image far more than the
total does, so a micro-step over the wrong images shows in them.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Tuple

import torch

PREDICT_TOP = 100
MATCH_IOU = 0.8


def _logit(s: torch.Tensor) -> torch.Tensor:
    s = s.double().clamp(1e-12, 1 - 1e-12)
    return torch.log(s / (1 - s))


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-8)


class DetectionTally:
    """Accumulates the detection numbers over sampled batches."""

    def __init__(self, top: int = PREDICT_TOP):
        self.top = top
        self.ref = self.missed = 0
        self.worst = 0.0
        self.gaps: List[torch.Tensor] = []

    def add(self, prog: Mapping[str, object], ref: Mapping[str, torch.Tensor]) -> None:
        """One batch: ``prog`` the program's numpy (or tensor) detections,
        ``ref`` the reference's for the same frames."""
        dev = ref["boxes"].device
        p = {k: torch.as_tensor(prog[k]).to(dev) for k in ("boxes", "scores", "labels", "valid")}
        for i in range(ref["boxes"].shape[0]):
            rv = ref["valid"][i]
            rb, rs, rl = (ref[k][i][rv][:self.top] for k in ("boxes", "scores", "labels"))
            pv = p["valid"][i].bool()
            pb, ps, pl = p["boxes"][i][pv].float(), p["scores"][i][pv], p["labels"][i][pv]
            n = rb.shape[0]
            if n == 0:
                continue
            if pb.shape[0]:
                iou = _iou(rb.float(), pb) * (rl[:, None].long() == pl[None, :].long())
                best, j = iou.max(dim=1)
            else:
                best, j = torch.zeros(n, device=dev), torch.zeros(n, dtype=torch.long, device=dev)
            hit = best > MATCH_IOU
            miss = int((~hit).sum())
            self.ref += n
            self.missed += miss
            self.worst = max(self.worst, miss / n)
            if bool(hit.any()):
                self.gaps.append((_logit(ps[j[hit]]) - _logit(rs[hit])).abs())

    def numbers(self) -> Dict[str, float]:
        gaps = torch.cat(self.gaps) if self.gaps else torch.full((1,), math.inf)
        return {"miss_share": self.missed / max(self.ref, 1),
                "worst_image_miss": self.worst if self.ref else 1.0,
                "logit_gap": float(gaps.mean())}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gap(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
              names: Iterable[str]) -> Tuple[float, str]:
    names = list(names)
    pn = {k: _norm(prog[k]) for k in names}
    rn = {k: _norm(ref[k]) for k in names}
    median = sorted(rn.values())[len(rn) // 2]
    worst, at = 0.0, ""
    for k in names:
        g = abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30)
        if not math.isfinite(g):
            return math.inf, k
        if g > worst:
            worst, at = g, k
    return worst, at


def _loss_gap(prog: List[float], ref: List[float]) -> float:
    if len(prog) != len(ref) or not all(map(math.isfinite, prog)):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def train_steps(prog_losses: List[float], ref_losses: List[float],
                prog_grad: Mapping[str, torch.Tensor], ref_grad: Mapping[str, torch.Tensor],
                prog_change: Mapping[str, torch.Tensor], ref_change: Mapping[str, torch.Tensor],
                prog_terms: List[Mapping[str, float]],
                ref_terms: List[Mapping[str, float]]) -> Tuple[Dict[str, float], Dict]:
    """(numbers, details): the module docstring's numbers and where the
    worst leaves were read. ``*_terms``: each micro-step's loss terms by
    name; a term the program leaves out reads as infinitely far."""
    names = sorted(ref_grad)
    grad, grad_at = _leaf_gap(prog_grad, ref_grad, names)
    gn = {k: _norm(ref_grad[k]) for k in names}
    median = sorted(gn.values())[len(gn) // 2]
    moved = [k for k in names if gn[k] >= 1e-3 * median]
    change, change_at = _leaf_gap(prog_change, ref_change, moved)
    numbers = {"loss_gap": _loss_gap(prog_losses, ref_losses), "grad_gap": grad,
               "change_gap": change}
    for t in (ref_terms[0] if ref_terms else ()):
        prog = [p.get(t, math.nan) for p in prog_terms]
        numbers[f"{t}_loss_gap"] = _loss_gap(prog, [r[t] for r in ref_terms])
    return (numbers,
            {"grad_gap_leaf": grad_at, "change_gap_leaf": change_at,
             "left_out_leaves": sorted(set(names) - set(moved)),
             "losses": list(prog_losses), "reference_losses": list(ref_losses)})


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict]:
    """(correct, compared): every limited number present, finite and at
    most its limit; ``compared`` maps each to its number and limit."""
    compared = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    ok = all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
