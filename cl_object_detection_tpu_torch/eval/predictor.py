"""Batched detection inference (the JAX package's ``eval/predictor.py``):
``make_predict_fn`` runs forward -> logit top-k -> decode -> clip ->
class-aware NMS over whole batches and static shapes, and
``detections_to_coco`` turns its output into COCO result rows."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PredictConfig
from ..data.transforms import logical_image_hw
from ..ops.anchors import anchors_for_shape
from ..ops.nms import Detections, detect_batch
from ..ops.quant import quantized_apply


def make_predict_fn(model, predict_cfg: PredictConfig,
                    bic_correct: Optional[Callable] = None):
    """Returns ``predict(images, class_scale=None, class_offset=None) ->
    Detections`` (padded, on the model's device).

    ``images`` is an NHWC tensor on the model's device (the weights live
    in ``model``; the JAX version takes them as an argument instead).
    ``class_scale``/``class_offset`` are an optional runtime per-class
    affine on the logits (the BiC correction); ``bic_correct`` is a
    callable on the logits that takes its place.

    ``nms_impl="pallas_fp"`` runs ``ops.nms_fp.nms_fp``, which picks by
    the tensors' device: the CUDA kernel on the card, its plain version
    on the CPU (identical keep masks).

    ``topk_method="approx"`` selects on the float32 cast of the logits
    by the exact stable top-k (``ops.nms._select_topk``), as XLA's
    ``approx_max_k`` does off the TPU.

    ``quantize=True`` runs the model through ``ops.quant.quantized_apply``:
    int8 convs (the int8 GEMM kernel on the card), head outputs and stem
    float. The model itself is not changed, so float and quantized
    predict functions of one model can be used side by side.
    """
    apply_fn = quantized_apply(model) if predict_cfg.quantize else model
    anchor_cache: Dict[Tuple[int, int, str], torch.Tensor] = {}

    @torch.inference_mode()
    def predict(images: torch.Tensor, class_scale=None, class_offset=None) -> Detections:
        h, w = logical_image_hw(images)
        key = (h, w, str(images.device))
        anchors = anchor_cache.get(key)
        if anchors is None:
            anchors = torch.tensor(anchors_for_shape(h, w), device=images.device)
            anchor_cache[key] = anchors
        logits, regression = apply_fn(images, enable_act=False)
        if bic_correct is not None:
            logits = bic_correct(logits)
        elif class_scale is not None:
            logits = logits * class_scale[None, None, :] + class_offset[None, None, :]
        # sigmoid is monotone: selection runs on logits and the sigmoid
        # touches only the k survivors
        return detect_batch(
            logits, regression, anchors, height=h, width=w,
            score_thresh=predict_cfg.score_thresh,
            iou_thresh=predict_cfg.nms_iou,
            pre_nms_topk=predict_cfg.pre_nms_topk,
            max_detections=predict_cfg.max_detections,
            nms_impl=predict_cfg.nms_impl,
            scores_are_logits=True,
            topk_method=predict_cfg.topk_method,
            bbox_std=tuple(predict_cfg.bbox_std))

    return predict


def detections_to_coco(
    det: Detections,
    batch,
    label_to_cat: Dict[int, int],
    score_thresh: float = 0.05,
    keep_slots: Optional[Sequence[bool]] = None,
) -> List[dict]:
    """Detections (tensors on any device) -> COCO result dicts: un-scale
    boxes to original pixels, xyxy -> xywh, drop pad slots.

    The four tensors come to the host in one copy; the un-scaling divides
    in numpy float32 as the JAX package does, so the rows are the same
    bytes. ``batch`` is a ``data.loader.Batch`` (host numpy ids and
    scales). ``keep_slots``: per-slot filter — the static loader
    wrap-fills short groups by REPEATING images inside one batch, so
    callers must emit each image's rows from exactly one slot."""
    b, d = det.scores.shape
    # one device -> host copy: float32 holds the labels (< 2**24) and the
    # valid bits exactly, and the boxes and scores bit for bit
    packed = torch.cat([det.boxes.float(), det.scores.float()[..., None],
                        det.labels.float()[..., None], det.valid.float()[..., None]],
                       dim=-1).cpu().numpy()
    boxes = packed[..., :4]
    scores = packed[..., 4]
    labels = packed[..., 5].astype(np.int64)
    valid = packed[..., 6] > 0
    out: List[dict] = []
    for i in range(b):
        if keep_slots is not None and not keep_slots[i]:
            continue
        img_id = int(batch.image_ids[i])
        if img_id < 0:
            continue
        scale = float(batch.scales[i])
        for j in np.where(valid[i] & (scores[i] > score_thresh))[0]:
            x1, y1, x2, y2 = boxes[i, j] / scale
            out.append(
                {
                    "image_id": img_id,
                    "category_id": int(label_to_cat[int(labels[i, j])]),
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "score": float(scores[i, j]),
                }
            )
    return out
