"""Pseudo-labels of old classes in new-state images (the JAX package's
``il/pseudo_label.py``).

The frozen previous-state model runs over the new state's training
images through the batched predict path (``eval/predictor.py``, on the
model's device); on the host, detections with score > ``score_thresh``
(0.7) whose IoU with EVERY real GT box of the image is below
``iou_thresh`` (0.35) are kept, at most ``max_labels_per_image``, and
stored as per-image COCO dicts that the dataset appends after the real
GT (``data/dataset.py``). The loss then discounts old-class false
positives on those anchors by training progress (``ops/focal_loss.py``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..config import PredictConfig, PseudoLabelConfig
from ..data.loader import BatchLoader
from ..eval.predictor import make_predict_fn


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros((0,))
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (box[2] - box[0]) * (box[3] - box[1])
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.clip(area_a + area_b - inter, 1e-8, None)


def generate_pseudo_labels(
    model,                        # the frozen previous-state model, on its device
    dataset,                      # ILDataset over the CURRENT state's new images
    data_cfg,
    cfg: PseudoLabelConfig,
    label_to_cat: Dict[int, int],
    mesh=None,
) -> Dict[int, List[dict]]:
    """``{image_id: [COCO annotation dicts]}``, one entry per image. On
    the mesh's data axis (``mesh=``) each rank predicts its whole batches
    of the loader (round robin) and the per-image rows of every batch are
    gathered to every rank and merged in the loader's order: one process's
    labels, bit for bit."""
    from ..parallel.mesh import gather_batches, pass_loader

    predict = make_predict_fn(model, PredictConfig(
        score_thresh=0.05, nms_iou=0.5, max_detections=cfg.max_labels_per_image * 4))
    device = next(model.parameters()).device
    loader = BatchLoader(dataset, data_cfg, shuffle=False, augment=False)

    per_batch = []
    for batch in pass_loader(mesh, loader):
        rows: List[tuple] = []
        per_batch.append(rows)
        det = predict(torch.from_numpy(batch.images).to(device))
        boxes = det.boxes.cpu().numpy()
        scores = det.scores.cpu().numpy()
        labels = det.labels.cpu().numpy()
        valid = det.valid.cpu().numpy()
        seen = set()
        for b in range(boxes.shape[0]):
            img_id = int(batch.image_ids[b])
            if img_id in seen:
                continue
            seen.add(img_id)
            scale = float(batch.scales[b])
            # the image's real GT rows in resized pixels: pseudo rows ride
            # as the annotation tail and must not suppress fresh teacher
            # detections of old-class objects
            n = int(batch.num_boxes[b]) - int(batch.num_pseudo[b])
            gt = batch.boxes[b, :n]
            anns: List[dict] = []
            for d in np.where(valid[b] & (scores[b] > cfg.score_thresh))[0]:
                if len(anns) >= cfg.max_labels_per_image:
                    break
                box = boxes[b, d]
                ious = _iou_one_to_many(box, gt)
                if len(ious) and ious.max() >= cfg.iou_thresh:
                    continue
                x1, y1, x2, y2 = box / scale          # float32, as JAX un-scales
                anns.append({
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "category_id": int(label_to_cat[int(labels[b, d])]),
                    "score": float(scores[b, d]),
                })
            rows.append((img_id, anns))
    # the loader's order; an image again in a later batch (a short group's
    # wrap-around) keeps its first batch's rows
    out: Dict[int, List[dict]] = {}
    for rows in gather_batches(mesh, per_batch):
        for img_id, anns in rows:
            out.setdefault(img_id, anns)
    return out
