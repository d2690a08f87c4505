"""RetinaNet classification / regression heads (the JAX package's
``models/heads.py``): a stack of 3x3 conv + ReLU, then a 3x3 output conv
giving ``A*4`` box deltas or ``A*C`` class logits per cell. The output
channel layout is anchor-major (channel = a*C + c) and the flattening
follows (h, w, anchor): the NCHW output is permuted to NHWC before the
reshape, or every anchor would be mis-ordered.

Output-layer init: weights 0; classification bias -log((1-prior)/prior),
regression bias 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv


def _flatten(out: torch.Tensor, per_cell: int) -> torch.Tensor:
    """NCHW (B, A*per_cell, H, W) -> (B, H*W*A, per_cell) in float32."""
    b = out.shape[0]
    return out.float().permute(0, 2, 3, 1).reshape(b, -1, per_cell)


class _Head(nn.Module):
    def __init__(self, out_channels: int, channels: int, num_layers: int,
                 dtype, generator, out_bias: float):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv{i + 1}", Conv(channels, channels, 3, 1, 1,
                                                 dtype=dtype, generator=generator))
        self.output = Conv(channels, out_channels, 3, 1, 1, dtype=dtype,
                           init="zeros")
        with torch.no_grad():
            self.output.bias.fill_(out_bias)

    def convs(self):
        return [getattr(self, f"conv{i + 1}") for i in range(self.num_layers)]


class RegressionHead(_Head):
    def __init__(self, num_anchors: int = 9, channels: int = 256,
                 num_layers: int = 4, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_anchors * 4, channels, num_layers, dtype,
                         generator, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs():
            x = F.relu(conv(x))
        return _flatten(self.output(x), 4)


class ClassificationHead(_Head):
    def __init__(self, num_classes: int, num_anchors: int = 9,
                 channels: int = 256, num_layers: int = 4,
                 prior: float = 0.01, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_anchors * num_classes, channels, num_layers,
                         dtype, generator, -math.log((1.0 - prior) / prior))
        self.num_classes = num_classes

    def extract_feature(self, x: torch.Tensor) -> torch.Tensor:
        """Trunk features: the last conv's output before its ReLU."""
        convs = self.convs()
        for conv in convs[:-1]:
            x = F.relu(conv(x))
        return convs[-1](x)

    def classify(self, feat: torch.Tensor, enable_act: bool = True) -> torch.Tensor:
        """ReLU + output conv (+ sigmoid) -> (B, H*W*A, C)."""
        out = _flatten(self.output(F.relu(feat)), self.num_classes)
        return torch.sigmoid(out) if enable_act else out

    def forward(self, x: torch.Tensor, enable_act: bool = True) -> torch.Tensor:
        return self.classify(self.extract_feature(x), enable_act)
