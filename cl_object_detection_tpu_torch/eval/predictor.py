"""Batched detection inference (the JAX package's ``eval/predictor.py``
``make_predict_fn``): forward -> logit top-k -> decode -> clip ->
class-aware NMS over whole batches and static shapes."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import PredictConfig
from ..data.transforms import logical_image_hw
from ..ops.anchors import anchors_for_shape
from ..ops.nms import Detections, detect_batch


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
    """
    if predict_cfg.quantize:
        raise ValueError("quantize=True (int8 predict path) is not ported")
    if predict_cfg.topk_method != "exact":
        raise ValueError(f"topk_method={predict_cfg.topk_method!r} is not "
                         "ported; use 'exact'")
    anchor_cache: Dict[Tuple[int, int, str], torch.Tensor] = {}

    @torch.inference_mode()
    def predict(images: torch.Tensor, class_scale=None, class_offset=None) -> Detections:
        h, w = logical_image_hw(images)
        key = (h, w, str(images.device))
        anchors = anchor_cache.get(key)
        if anchors is None:
            anchors = torch.tensor(anchors_for_shape(h, w), device=images.device)
            anchor_cache[key] = anchors
        logits, regression = model(images, enable_act=False)
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
