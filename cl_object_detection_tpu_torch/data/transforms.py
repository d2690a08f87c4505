"""Host-side image transforms producing static canonical shapes (numpy).

Own copies of the JAX package's ``data/transforms.py``: every image is
resized so its short side reaches ``min_side`` with its long side at most
``max_side``, then zero-padded into one of a few canonical frames
(landscape ``(height, width)``, portrait ``(width, height)``, plus the
optional ``shape_buckets``), so batches have static shapes.

The one function that is the port's own is the resize in
``resize_and_pad``: ``resize_bilinear``, a half-pixel-centred bilinear
resize without antialiasing, clamped at the edges, and an exact copy
when the size does not change, on ``torch.nn.functional.interpolate``
over CPU tensors. It is the same on every machine, whatever image
libraries are installed. It interpolates in float64: in float32,
interpolate computes the source coordinates in float32, where OpenCV's
``INTER_LINEAR`` computes them in double, and the two drift apart at
VOC-like sizes; in float64 it stays within one float32 spacing of
OpenCV (tests/test_torch_data.py).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def pick_canonical(
    nh: int, nw: int, height: int, width: int,
    buckets: Tuple[Tuple[int, int], ...] = (),
) -> Tuple[int, int]:
    """Smallest canonical frame that fits a (nh, nw) RESIZED image.

    ``buckets`` are extra landscape-form frames (h, w), h <= w, each a
    multiple of 32; portrait images use their transposes. The default
    (height, width) frame is always a candidate, so an image that fits no
    bucket falls back to it."""
    land = nw >= nh
    best = (height, width) if land else (width, height)
    for bh, bw in buckets:
        if not land:
            bh, bw = bw, bh
        if nh <= bh and nw <= bw and bh * bw < best[0] * best[1]:
            best = (bh, bw)
    return best


def compute_scale(h: int, w: int, min_side: int, max_side: int) -> float:
    """The resize scale: short side to ``min_side`` unless that takes the
    long side past ``max_side``."""
    smallest = min(h, w)
    largest = max(h, w)
    scale = min_side / smallest
    if largest * scale > max_side:
        scale = max_side / largest
    return scale


def resize_bilinear(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(H, W, C) float32 -> (nh, nw, C) float32, bilinear with half-pixel
    centres, no antialiasing, edges clamped, computed in float64; a copy
    when the size does not change."""
    h, w = image.shape[:2]
    if (nh, nw) == (h, w):
        return np.array(image, np.float32)
    x = torch.from_numpy(np.asarray(image, np.float64)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                        antialias=False)
    return out[0].permute(1, 2, 0).to(torch.float32).numpy()


def resize_and_pad(
    image: np.ndarray,
    boxes: np.ndarray,
    min_side: int,
    max_side: int,
    height: int,
    width: int,
    buckets: Tuple[Tuple[int, int], ...] = (),
    frame: Tuple[int, int] = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Resize (``resize_bilinear``) + zero-pad into the canonical frame.

    Args:
      image: (H, W, 3) float32 in [0, 1].
      boxes: (N, 4) xyxy in source pixels.
      frame: force this canonical (h, w) instead of re-deriving it from the
        decoded shape: the batch loader passes its metadata-derived group
        frame, so a metadata/file disagreement (EXIF rotation) cannot land
        one example of a batch in another frame.
    Returns:
      (padded image (Hc, Wc, 3), scaled boxes, scale).
    """
    h, w = image.shape[:2]
    scale = compute_scale(h, w, min_side, max_side)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ch, cw = frame if frame is not None else pick_canonical(
        nh, nw, height, width, buckets)
    if nh > ch or nw > cw:
        # forced frame smaller than the scaled image: shrink UNIFORMLY so
        # boxes and the returned scale stay consistent with the pixels
        scale = min(scale, ch / h, cw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
    nh, nw = min(nh, ch), min(nw, cw)   # guard rounding

    out = np.zeros((ch, cw, 3), dtype=np.float32)
    out[:nh, :nw] = resize_bilinear(image, nh, nw)
    if boxes.size:
        boxes = boxes * scale
    return out, boxes.astype(np.float32), float(scale)


def hflip(image: np.ndarray, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip with xyxy box remap, on the UNPADDED image."""
    w = image.shape[1]
    image = image[:, ::-1].copy()
    if boxes.size:
        boxes = boxes.copy()
        x1 = boxes[:, 0].copy()
        x2 = boxes[:, 2].copy()
        boxes[:, 0] = w - x2
        boxes[:, 2] = w - x1
    return image, boxes


def pad_annotations(
    boxes: np.ndarray, labels: np.ndarray, max_boxes: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad (N,4)/(N,) GT to static (max_boxes, 4)/(max_boxes,) with -1
    sentinel rows; returns the kept count too."""
    n = min(len(boxes), max_boxes)
    out_boxes = np.full((max_boxes, 4), -1.0, dtype=np.float32)
    out_labels = np.full((max_boxes,), -1, dtype=np.int32)
    if n:
        out_boxes[:n] = boxes[:n]
        out_labels[:n] = labels[:n]
    return out_boxes, out_labels, n


def normalize_image(image: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """ImageNet normalization of a float image in [0, 1]."""
    return (image - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def space_to_depth(images: np.ndarray, factor: int = 2) -> np.ndarray:
    """Space-to-depth for the phase-packed stem convs.

    ``factor=2``: ``(B, H, W, C) -> (B, H/2, W/2, 4C)`` with channel order
    (row-phase, col-phase, c). ``factor=4``: ``(B, H, W, 3) ->
    (B, H/4, W/4, 64)``: 48 phase channels + 16 zero channels, the input
    of the fused stem (ops/stem_fused.py). H and W must be multiples of 4.
    """
    b, h, w, c = images.shape
    if h % 4 or w % 4:
        raise ValueError(f"frame {h}x{w} is not a multiple of 4")
    f = factor
    out = images.reshape(b, h // f, f, w // f, f, c)
    out = out.transpose(0, 1, 3, 2, 4, 5)
    out = np.ascontiguousarray(out.reshape(b, h // f, w // f, f * f * c))
    if factor == 4:
        pad = np.zeros(out.shape[:3] + (64 - out.shape[-1],), out.dtype)
        out = np.concatenate([out, pad], axis=-1)
    return out


def logical_image_hw(images) -> Tuple[int, int]:
    """The logical (full-resolution) height and width of an NHWC batch,
    undoing space-to-depth (12 channels: /2, 64 channels: /4)."""
    h, w = int(images.shape[1]), int(images.shape[2])
    if images.shape[-1] == 12:
        return 2 * h, 2 * w
    if images.shape[-1] == 64:
        return 4 * h, 4 * w
    return h, w
