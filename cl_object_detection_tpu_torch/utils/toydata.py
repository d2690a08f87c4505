"""Synthetic COCO-json toy dataset for tests and smoke training (own copy
of the JAX package's ``utils/toydata.py``): coloured rectangles on noise
backgrounds, one JSON per split, so every stage (dataset -> loader ->
train) can run hermetically. The generator and its RNG are the JAX
package's, so the pixel arrays, boxes and JSON match; the images are
written as PNG (``data/image_io.write_png``), which the port decodes
without OpenCV or PIL.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import colorsys

import numpy as np

from ..data.image_io import write_png

DEFAULT_CLASSES = ("circleish", "square", "wide", "tall", "tiny")

# separable style: 10 max-spread hues × 4 fill patterns = 40 cleanly
# distinct classes, so a trained detector can actually tell them apart
# (the legacy shade-only palette makes 20 classes deliberately confusable
# — fine for pinning DELTAS, useless for absolute-mAP operating points)
_N_HUES = 10
_PATTERNS = ("solid", "hollow", "stripes", "checker")


def _class_color(cls: int) -> np.ndarray:
    """Saturated RGB for hue slot ``cls % _N_HUES`` (36° spacing)."""
    r, g, b = colorsys.hsv_to_rgb((cls % _N_HUES) / _N_HUES, 1.0, 1.0)
    return (np.array([r, g, b]) * 255).astype(np.uint8)


def _separable_patch(cls: int, bh: int, bw: int) -> np.ndarray:
    """Class-unique (bh, bw, 3) patch: hue by ``cls % 10``, fill pattern
    by ``cls // 10`` (solid / hollow frame / stripes / checkerboard)."""
    color = _class_color(cls)
    dark = (color // 5).astype(np.uint8)
    patch = np.broadcast_to(color, (bh, bw, 3)).copy()
    pattern = _PATTERNS[(cls // _N_HUES) % len(_PATTERNS)]
    if pattern == "hollow":
        y0, y1 = bh // 4, max(bh // 4 + 1, 3 * bh // 4)
        x0, x1 = bw // 4, max(bw // 4 + 1, 3 * bw // 4)
        patch[y0:y1, x0:x1] = dark
    elif pattern == "stripes":
        step = max(4, bh // 6)
        rows = (np.arange(bh) // step) % 2 == 1
        patch[rows] = dark
    elif pattern == "checker":
        step_y, step_x = max(4, bh // 4), max(4, bw // 4)
        yy = (np.arange(bh) // step_y)[:, None]
        xx = (np.arange(bw) // step_x)[None, :]
        patch[((yy + xx) % 2) == 1] = dark
    return patch


def _iou_xywh(a, b) -> float:
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    ix = max(0.0, min(ax + aw, bx + bw) - max(ax, bx))
    iy = max(0.0, min(ay + ah, by + bh) - max(ay, by))
    inter = ix * iy
    return inter / (aw * ah + bw * bh - inter + 1e-9)


def make_toy_dataset(
    root: str,
    num_images: int = 16,
    classes: Sequence[str] = DEFAULT_CLASSES,
    image_size: Tuple[int, int] = (240, 320),   # (h, w); some get transposed
    max_objects: int = 3,
    seed: int = 0,
    split: str = "train",
    style: str = "legacy",
) -> str:
    """Writes images/ + annotations JSON under root; returns the JSON path.

    ``style="legacy"`` keeps the original shade-only palette (confusable
    classes — what the delta-pinning A/B fixtures were measured on);
    ``style="separable"`` gives each class a unique hue × fill pattern
    and rejects heavily-overlapping placements, so a properly trained
    detector reaches a meaningful absolute mAP50 (≥0.5) and accuracy
    A/Bs have statistical power."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    images, annotations = [], []
    categories = [
        {"id": i + 1, "name": n, "supercategory": "toy"}
        for i, n in enumerate(classes)
    ]
    ann_id = 1
    for idx in range(num_images):
        h, w = image_size if idx % 3 else (image_size[1], image_size[0])
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        # the first 2*C images are single-object single-class (class idx % C)
        # so exemplar/replay sampling always has class-exclusive images
        exclusive = idx < 2 * len(classes)
        n_obj = 1 if exclusive else rng.randint(1, max_objects + 1)
        img_id = idx + 1
        placed: List[Tuple[float, float, float, float]] = []
        for _ in range(n_obj):
            cls = idx % len(classes) if exclusive else int(rng.randint(0, len(classes)))
            bw = int(rng.randint(30, max(31, w // 2)))
            bh = int(rng.randint(30, max(31, h // 2)))
            x = int(rng.randint(0, max(1, w - bw)))
            y = int(rng.randint(0, max(1, h - bh)))
            if style == "separable":
                # rejection-sample a placement with low overlap so GT
                # boxes stay visually unoccluded (overlap = label noise)
                for _try in range(10):
                    if all(_iou_xywh((x, y, bw, bh), p) < 0.1 for p in placed):
                        break
                    x = int(rng.randint(0, max(1, w - bw)))
                    y = int(rng.randint(0, max(1, h - bh)))
                else:
                    continue  # couldn't place without overlap: drop object
                placed.append((x, y, bw, bh))
                img[y : y + bh, x : x + bw] = _separable_patch(cls, bh, bw)
            else:
                color = np.zeros(3, np.uint8)
                # clamp: >17 classes would wrap uint8 (260 -> 4) and produce
                # near-invisible boxes; keep the per-class shade distinct below
                color[cls % 3] = min(255, 200 + 10 * (cls // 3))
                if cls // 3 >= 6:  # distinguish clamped classes via 2nd channel
                    # cycle in [60, 250] so classes beyond ~30 stay distinct
                    # instead of all clamping to 255
                    color[(cls + 1) % 3] = 60 + (20 * (cls // 3)) % 191
                img[y : y + bh, x : x + bw] = color
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": cls + 1,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh),
                    "iscrowd": 0,
                }
            )
            ann_id += 1
        fname = f"{split}_{img_id:04d}.png"
        write_png(os.path.join(img_dir, fname), img)
        images.append(
            {"id": img_id, "file_name": fname, "height": h, "width": w}
        )

    data = {"images": images, "annotations": annotations, "categories": categories}
    json_path = os.path.join(root, f"{split}.json")
    with open(json_path, "w") as f:
        json.dump(data, f)
    return json_path
