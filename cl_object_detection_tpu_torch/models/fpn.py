"""Feature Pyramid Network P3-P7 (the JAX package's ``models/fpn.py``):
1x1 laterals on C3-C5, nearest 2x top-down adds, 3x3 smoothing convs,
P6 = 3x3/2 conv on C5, P7 = ReLU + 3x3/2 conv on P6. NCHW in and out."""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    def __init__(self, in_channels, channels: int = 256,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c3, c4, c5 = in_channels
        conv = lambda ci, k, s=1, p=0: Conv(ci, channels, k, s, p, dtype=dtype,
                                            generator=generator)
        self.p5_lateral = conv(c5, 1)
        self.p5_smooth = conv(channels, 3, 1, 1)
        self.p4_lateral = conv(c4, 1)
        self.p4_smooth = conv(channels, 3, 1, 1)
        self.p3_lateral = conv(c3, 1)
        self.p3_smooth = conv(channels, 3, 1, 1)
        self.p6 = conv(c5, 3, 2, 1)
        self.p7 = conv(channels, 3, 2, 1)

    def forward(self, c3, c4, c5) -> List[torch.Tensor]:
        p5 = self.p5_lateral(c5)
        p5_up = upsample2x_nearest(p5)
        p5 = self.p5_smooth(p5)

        p4 = self.p4_lateral(c4) + p5_up
        p4_up = upsample2x_nearest(p4)
        p4 = self.p4_smooth(p4)

        p3 = self.p3_lateral(c3) + p4_up
        p3 = self.p3_smooth(p3)

        p6 = self.p6(c5)
        p7 = self.p7(F.relu(p6))
        return [p3, p4, p5, p6, p7]
