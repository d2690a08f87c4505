"""The inputs of a run, made on the device from ``--seed``: frames,
their 4x4 space-to-depth packing (the program's fused-stem input), and
ground truth. The same seed gives the same inputs; every seed gives the
same sizes."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# sub-seeds of one run's seed, one per kind of input
WEIGHTS, FRAMES, TRUTH, STUDENT, SAMPLE = range(5)


def sub_seed(seed: int, tag: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * tag) % (2 ** 62)


def frames(seed: int, count: int, frame_hw: Sequence[int], image_hw: Sequence[int],
           device) -> torch.Tensor:
    """(count, H, W, 3) uint8 RGB noise in the top-left ``image_hw`` of
    each frame, zero beyond it (the letterbox's padding)."""
    h, w = frame_hw
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, FRAMES))
    out = torch.zeros((count, h, w, 3), dtype=torch.uint8, device=device)
    ih, iw = image_hw
    out[:, :ih, :iw] = torch.randint(0, 256, (count, ih, iw, 3), generator=g,
                                     dtype=torch.uint8, device=device)
    return out


def pack(rgb: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H/4, W/4, 64): the 4x4 blocks' 48 values in
    (row phase, column phase, channel) order, then 16 zero channels."""
    b, h, w, c = rgb.shape
    x = rgb.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, h // 4, w // 4, 16 * c)
    return torch.cat([x, x.new_zeros(b, h // 4, w // 4, 64 - 16 * c)], dim=-1).contiguous()


def truth(seed: int, count: int, slots: int, per_image: int, side: Sequence[int],
          image_hw: Sequence[int], labels: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Ground truth of ``count`` images: ``per_image`` boxes each in
    ``slots`` slots (-1 padded), sides uniform in ``side``, inside the
    image, labels uniform over ``labels``; host numpy float32 / int32."""
    r = np.random.default_rng(sub_seed(seed, TRUTH))
    ih, iw = image_hw
    wh = r.uniform(side[0], side[1], (count, per_image, 2))
    x1 = r.uniform(0, 1, (count, per_image)) * (iw - wh[..., 0])
    y1 = r.uniform(0, 1, (count, per_image)) * (ih - wh[..., 1])
    boxes = np.full((count, slots, 4), -1, np.float32)
    boxes[:, :per_image] = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], -1)
    lab = np.full((count, slots), -1, np.int32)
    lab[:, :per_image] = r.choice(np.asarray(labels, np.int32), (count, per_image))
    return boxes, lab


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack``: (B, H/4, W/4, 64) -> (B, H, W, 3)."""
    b, h4, w4, _ = packed.shape
    x = packed[..., :48].reshape(b, h4, w4, 4, 4, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h4 * 4, w4 * 4, 3)
