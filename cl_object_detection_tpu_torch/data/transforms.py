"""Host-side image transforms (numpy): normalization, space-to-depth and
the logical frame size of a batch. Own copies of the JAX package's
``data/transforms.py`` functions of the same names."""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


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
