"""Anchor generation per static image shape (numpy).

Pyramid levels 3-7, stride 2^l, base size 2^(l+2), 3 ratios {0.5, 1, 2}
x 3 scales {1, 2^1/3, 2^2/3} = 9 anchors per cell, laid out level-major,
cell-row-major, ratio-major/scale-minor. Feature-map sizes use
ceil(image/2^l). Bit-equal to the JAX package's ``ops/anchors.py``.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

RATIOS = (0.5, 1.0, 2.0)
SCALES = (2.0 ** 0.0, 2.0 ** (1.0 / 3.0), 2.0 ** (2.0 / 3.0))


def generate_base_anchors(
    base_size: float,
    ratios: Sequence[float] = RATIOS,
    scales: Sequence[float] = SCALES,
) -> np.ndarray:
    """(len(ratios)*len(scales), 4) xyxy anchors centered at the origin;
    each has area (base_size*scale)^2 distributed by aspect ratio h/w."""
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    n = len(ratios) * len(scales)
    side = base_size * np.tile(scales, len(ratios))
    areas = side * side
    r = np.repeat(ratios, len(scales))
    w = np.sqrt(areas / r)
    h = w * r
    out = np.stack([-w / 2, -h / 2, w / 2, h / 2], axis=1)
    return out.astype(np.float32).reshape(n, 4)


def feature_shapes(
    height: int, width: int, pyramid_levels: Sequence[int] = (3, 4, 5, 6, 7)
) -> Tuple[Tuple[int, int], ...]:
    """Per-level (H, W) by ceil division."""
    return tuple(
        ((height + 2**l - 1) // 2**l, (width + 2**l - 1) // 2**l)
        for l in pyramid_levels
    )


@functools.lru_cache(maxsize=16)
def anchors_for_shape(
    height: int,
    width: int,
    pyramid_levels: Tuple[int, ...] = (3, 4, 5, 6, 7),
) -> np.ndarray:
    """All anchors for a canonical image shape: (sum_l Hl*Wl*9, 4) xyxy
    float32, cell centers at (i + 0.5) * stride. The cached array is
    shared: callers copy before writing to it."""
    chunks = []
    for (fh, fw), level in zip(feature_shapes(height, width, pyramid_levels), pyramid_levels):
        stride = 2**level
        base = generate_base_anchors(2.0 ** (level + 2))
        sx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
        sy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
        cx, cy = np.meshgrid(sx, sy)
        shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
        chunks.append((shifts + base[None]).reshape(-1, 4))
    out = np.concatenate(chunks, axis=0).astype(np.float32)
    out.flags.writeable = False
    return out


def num_anchors_for_shape(
    height: int, width: int, pyramid_levels: Tuple[int, ...] = (3, 4, 5, 6, 7)
) -> int:
    return sum(fh * fw * 9 for fh, fw in feature_shapes(height, width, pyramid_levels))
