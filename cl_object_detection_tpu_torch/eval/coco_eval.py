"""COCO-protocol detection evaluation (own copy of the JAX package's
``eval/coco_eval.py``): greedy score-ordered matching per (image, class)
at IoU thresholds 0.50:0.05:0.95, 101-point interpolated AP, and AR as
the mean max-recall over thresholds, maxDets=100.

Per class it gives what the reference's evaluator consumes: AP@0.5
("stats[1]") and AR@[.5:.95] with maxDets=100 ("stats[8]"), evaluated
with catIds=[class] on the test split's image list.

Implementation notes for parity with pycocotools semantics:
  * detections sorted by score with a STABLE sort (mergesort), capped at
    maxDets per image;
  * greedy match: each detection takes the not-yet-matched GT with the
    highest IoU >= threshold;
  * iscrowd GT is excluded;
  * precision envelope: running max from the right; AP = mean of
    interpolated precision at recalls 0, 0.01, ..., 1.00 (searchsorted
    'left');
  * boxes are xywh (COCO result format); IoU on corner form.

Two paths with the JAX package's dtypes: the Python path (the semantic
oracle) in float64 boxes, the C++ core (``native/coco_eval.cpp``) on
float32 boxes and scores. ``use_native=True`` runs the C++ core or
raises; the Python path runs only when the caller asks for it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05).round(2)  # 0.5 ... 0.95
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
MAX_DETS = 100


@dataclass
class EvalResult:
    ap50: Dict[str, float] = field(default_factory=dict)      # stats[1] per class
    recall: Dict[str, float] = field(default_factory=dict)    # stats[8] per class
    pred_num: int = 0
    real_num: int = 0

    @property
    def mean_ap50(self) -> float:
        vals = [v for v in self.ap50.values() if v > -1]
        return float(np.mean(vals)) if vals else -1.0

    @property
    def mean_recall(self) -> float:
        vals = [v for v in self.recall.values() if v > -1]
        return float(np.mean(vals)) if vals else -1.0


def _iou_xywh(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """IoU matrix between xywh boxes: (D, G)."""
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None
    )
    inter = iw * ih
    union = (dets[:, 2] * dets[:, 3])[:, None] + (gts[:, 2] * gts[:, 3])[None] - inter
    return inter / np.clip(union, 1e-9, None)


class CocoProtocolEval:
    """Evaluate COCO-format results against COCO-format GT.

    Args:
      gt: the annotation index (data.coco.CocoJson or a compatible object
        with ``imgs``, ``classes``, ``get_anns_by_img``).
      image_ids: images to evaluate over (the test split's list).
    """

    def __init__(self, gt, image_ids: Sequence[int]):
        self.gt = gt
        self.image_ids = list(image_ids)

    # ------------------------------------------------------------------
    def evaluate_class(
        self,
        results: Sequence[dict],
        cat_id: int,
        image_ids: Optional[Sequence[int]] = None,
        max_dets: int = MAX_DETS,
        use_native: bool = True,
    ):
        """Returns (ap50, ar) for one category — the reference's
        stats[1]/stats[8] pair (evaluator.py:219-220). -1 when no GT.

        ``use_native=True`` runs the C++ core (native/coco_eval.cpp) and
        raises when it cannot be built; ``use_native=False`` runs the
        Python path below, the semantic oracle.
        """
        image_ids = list(image_ids) if image_ids is not None else self.image_ids
        img_set = set(image_ids)

        if use_native:
            return self._evaluate_class_native(results, cat_id, image_ids, max_dets)

        # group GT and detections per image
        gt_by_img: Dict[int, List[List[float]]] = {i: [] for i in image_ids}
        for i in image_ids:
            for a in self.gt.get_anns_by_img(i):
                if a["category_id"] == cat_id and not a.get("iscrowd", 0):
                    gt_by_img[i].append(a["bbox"])
        det_by_img: Dict[int, List] = {i: [] for i in image_ids}
        for r in results:
            if r["category_id"] == cat_id and r["image_id"] in img_set:
                det_by_img[r["image_id"]].append((float(r["score"]), r["bbox"]))

        n_gt = sum(len(v) for v in gt_by_img.values())
        if n_gt == 0:
            return -1.0, -1.0

        T = len(IOU_THRESHOLDS)
        all_scores: List[np.ndarray] = []
        all_matches: List[np.ndarray] = []   # (T, D) bool: matched at thresh t

        for i in image_ids:
            dets = det_by_img[i]
            gts = np.asarray(gt_by_img[i], np.float64).reshape(-1, 4)
            if not dets:
                continue
            scores = np.asarray([d[0] for d in dets])
            order = np.argsort(-scores, kind="mergesort")[:max_dets]
            scores = scores[order]
            boxes = np.asarray([dets[j][1] for j in order], np.float64).reshape(-1, 4)

            D = len(scores)
            matched = np.zeros((T, D), bool)
            if len(gts):
                ious = _iou_xywh(boxes, gts)
                for t, thr in enumerate(IOU_THRESHOLDS):
                    taken = np.zeros(len(gts), bool)
                    thr = min(thr, 1.0 - 1e-10)
                    for d in range(D):
                        best, bm = thr, -1
                        for g in range(len(gts)):
                            if taken[g] or ious[d, g] < best:
                                continue
                            best, bm = ious[d, g], g
                        if bm >= 0:
                            taken[bm] = True
                            matched[t, d] = True
            all_scores.append(scores)
            all_matches.append(matched)

        if not all_scores:
            return 0.0, 0.0

        scores = np.concatenate(all_scores)
        matches = np.concatenate(all_matches, axis=1)          # (T, total_D)
        order = np.argsort(-scores, kind="mergesort")
        matches = matches[:, order]

        tp = np.cumsum(matches, axis=1, dtype=np.float64)
        fp = np.cumsum(~matches, axis=1, dtype=np.float64)
        rc = tp / n_gt
        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)

        # AP@0.5 with 101-pt interpolation (t = 0)
        ap50 = self._interp_ap(pr[0], rc[0])
        # AR: mean over thresholds of final recall
        ar = float(np.mean(rc[:, -1])) if rc.shape[1] else 0.0
        return ap50, ar

    def _evaluate_class_native(self, results, cat_id, image_ids, max_dets):
        from ..native import coco_eval_class_native

        idx_of = {im: i for i, im in enumerate(image_ids)}
        det_img, det_score, det_box = [], [], []
        for r in results:
            if r["category_id"] == cat_id and r["image_id"] in idx_of:
                det_img.append(idx_of[r["image_id"]])
                det_score.append(r["score"])
                det_box.append(r["bbox"])
        gt_img, gt_box = [], []
        for im in image_ids:
            for a in self.gt.get_anns_by_img(im):
                if a["category_id"] == cat_id and not a.get("iscrowd", 0):
                    gt_img.append(idx_of[im])
                    gt_box.append(a["bbox"])
        if not gt_img:
            return (-1.0, -1.0)
        return coco_eval_class_native(
            np.asarray(det_img, np.int32),
            np.asarray(det_score, np.float32),
            np.asarray(det_box, np.float32).reshape(-1, 4),
            np.asarray(gt_img, np.int32),
            np.asarray(gt_box, np.float32).reshape(-1, 4),
            n_imgs=len(image_ids),
            max_dets=max_dets,
        )

    @staticmethod
    def _interp_ap(precision: np.ndarray, recall: np.ndarray) -> float:
        # precision envelope (monotone non-increasing from the right)
        pr = precision.copy()
        for i in range(len(pr) - 1, 0, -1):
            pr[i - 1] = max(pr[i - 1], pr[i])
        idx = np.searchsorted(recall, RECALL_THRESHOLDS, side="left")
        q = np.zeros(len(RECALL_THRESHOLDS))
        valid = idx < len(pr)
        q[valid] = pr[idx[valid]]
        return float(np.mean(q))

    # ------------------------------------------------------------------
    def evaluate(
        self,
        results: Sequence[dict],
        cat_ids: Iterable[int],
        ignore_other_img: bool = False,
        use_native: bool = True,
    ) -> EvalResult:
        """Per-class sweep mirroring the reference's do_evaluation."""
        out = EvalResult()
        cats = list(cat_ids)   # materialize: a generator would be consumed
        for cid in cats:
            name = self.gt.classes[cid]
            imgs = (
                self.gt.get_imgs_by_cats(cid) if ignore_other_img else None
            )
            ap, ar = self.evaluate_class(results, cid, image_ids=imgs,
                                         use_native=use_native)
            out.ap50[name] = ap
            out.recall[name] = ar
        out.pred_num = len(results)
        cat_set = set(cats)
        out.real_num = sum(
            1
            for i in self.image_ids
            for a in self.gt.get_anns_by_img(i)
            if a["category_id"] in cat_set
        )
        return out
