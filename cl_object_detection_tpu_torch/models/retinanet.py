"""The full RetinaNet: backbone + FPN + heads (the JAX package's
``models/retinanet.py``).

  * ``forward(images, enable_act)`` -> (cls (B,A,C), reg (B,A,4))
  * ``forward_all(images, enable_act)`` -> (cls, reg, [P3..P7])

``images`` is an NHWC batch: ``(B,H,W,3)``, ``(B,H/2,W/2,12)`` or
``(B,H/4,W/4,64)``, float (normalized) or uint8 (normalized on the
device). The heads are shared across the five levels and their outputs
concatenate along the anchor axis in P3..P7 order, matching
``ops/anchors.py``. The features come back NCHW.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from ..config import ModelConfig
from .fpn import FPN
from .heads import ClassificationHead, RegressionHead
from .resnet import ResNetBackbone

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class RetinaNet(nn.Module):
    def __init__(self, depth: int = 50, num_classes: int = 20,
                 fpn_channels: int = 256, num_anchors: int = 9,
                 prior: float = 0.01, head_layers: int = 4,
                 dtype: torch.dtype = torch.float32,
                 input_mean=(0.485, 0.456, 0.406),
                 input_std=(0.229, 0.224, 0.225),
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.backbone = ResNetBackbone(depth, dtype, input_mean, input_std,
                                       generator, remat)
        self.fpn = FPN(ResNetBackbone.stage_channels(depth), fpn_channels,
                       dtype, generator)
        self.regression_head = RegressionHead(num_anchors, fpn_channels,
                                              head_layers, dtype, generator)
        self.classification_head = ClassificationHead(
            num_classes, num_anchors, fpn_channels, head_layers, prior, dtype,
            generator)

    def _features(self, images) -> List[torch.Tensor]:
        c3, c4, c5 = self.backbone(images)
        return self.fpn(c3, c4, c5)

    def _heads(self, feats, enable_act: bool):
        reg = torch.cat([self.regression_head(f) for f in feats], dim=1)
        cls = torch.cat([self.classification_head(f, enable_act) for f in feats],
                        dim=1)
        return cls, reg

    def forward(self, images, enable_act: bool = True):
        return self._heads(self._features(images), enable_act)

    def forward_all(self, images, enable_act: bool = True):
        feats = self._features(images)
        cls, reg = self._heads(feats, enable_act)
        return cls, reg, feats


def create_retinanet(cfg: ModelConfig, num_classes: int, device=None,
                     generator: Optional[torch.Generator] = None) -> RetinaNet:
    """Build the model of ``cfg`` on ``device`` (CUDA unless the caller
    asks for the CPU), in eval mode. Initial weights come from
    ``generator`` (a ``torch.Generator`` on the CPU), or PyTorch's default
    generator when None."""
    from .. import resolve_device

    if tuple(cfg.pyramid_levels) != (3, 4, 5, 6, 7):
        raise ValueError("pyramid_levels is fixed to P3-P7 (the FPN, heads "
                         f"and anchor grids are built for 5 levels); got "
                         f"{cfg.pyramid_levels}")
    if cfg.param_dtype != "float32":
        raise ValueError("params are kept float32; got "
                         f"param_dtype={cfg.param_dtype}")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
    device = resolve_device(device)
    model = RetinaNet(
        depth=cfg.depth, num_classes=num_classes,
        fpn_channels=cfg.fpn_channels, num_anchors=cfg.num_anchors,
        prior=cfg.prior, head_layers=cfg.head_layers,
        dtype=_DTYPES[cfg.compute_dtype],
        input_mean=tuple(cfg.input_mean), input_std=tuple(cfg.input_std),
        generator=generator, remat=cfg.remat)
    return model.to(device).eval()
