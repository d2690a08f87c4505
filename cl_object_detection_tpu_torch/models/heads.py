"""RetinaNet classification / regression heads (the JAX package's
``models/heads.py``): a stack of 3x3 conv + ReLU, then a 3x3 output conv
giving ``A*4`` box deltas or ``A*C`` class logits per cell. The output
channel layout is anchor-major (channel = a*C + c) and the flattening
follows (h, w, anchor): the NCHW output is permuted to NHWC before the
reshape, or every anchor would be mis-ordered.

Output-layer init: weights 0; classification bias -log((1-prior)/prior),
regression bias 0.

The model axis (``parallel/mesh.py``, JAX's ``head_tp_spec``): inside
``head_parallel(model, mesh)`` the trunks of ``model``'s two heads run
split over ``mesh``'s model group on the rank's slices of their whole
weights (views): ``conv1``/``conv3`` column-parallel, every other
``convN`` row-parallel, the activations split between a column-parallel
conv and the next row-parallel one, joined (or sliced) where the rule
meets a replicated neighbour. The train step runs its student's forward
so; every other forward (the teacher's, the tool passes', predict) runs
the whole trunk. The parameters and their names are the same either way.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv, conv2d

# (the heads whose trunks run split, the mesh), inside ``head_parallel``
_HEAD_PARALLEL: ContextVar = ContextVar("head_parallel", default=None)


@contextmanager
def head_parallel(model: nn.Module, mesh):
    """Within it, ``model``'s head trunks run split over ``mesh``'s model
    group (module docstring); a no-op without a model axis."""
    from ..parallel.mesh import model_active

    if not model_active(mesh):
        yield
        return
    token = _HEAD_PARALLEL.set(((model.regression_head, model.classification_head), mesh))
    try:
        yield
    finally:
        _HEAD_PARALLEL.reset(token)


def _flatten(out: torch.Tensor, per_cell: int) -> torch.Tensor:
    """NCHW (B, A*per_cell, H, W) -> (B, H*W*A, per_cell) in float32."""
    b = out.shape[0]
    return out.float().permute(0, 2, 3, 1).reshape(b, -1, per_cell)


class _Head(nn.Module):
    flax_name = ""                    # the flax module name, in the parameter names

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

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The last trunk conv's output before its ReLU, whole (split over
        the model group inside ``head_parallel``)."""
        split = _HEAD_PARALLEL.get()
        if split is not None and any(self is h for h in split[0]):
            return self._split_trunk(x, split[1])
        convs = self.convs()
        for conv in convs[:-1]:
            x = F.relu(conv(x))
        return convs[-1](x) if convs else x

    def _split_trunk(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """``trunk`` on this rank's slices (``parallel.mesh.head_tp_shard``):
        a column-parallel conv takes the whole input (*f*) and gives its
        slice of the output channels; a row-parallel conv takes its slice
        of the input channels and its partial outputs are summed over the
        model group (*g*) before the whole bias is added."""
        from ..parallel import mesh as pm

        split = False
        for i, conv in enumerate(self.convs()):
            if i:
                x = F.relu(x)
            prefix = f"{self.flax_name}.conv{i + 1}."
            w = pm.shard_of(conv.weight, (pm.head_tp_shard(
                prefix + "weight", conv.weight.shape, mesh.num_model, mesh.model_index),))
            if pm.head_tp_kind(prefix + "weight") == "column":
                if split:
                    x = pm.gather_from_model(mesh, x)
                b = pm.shard_of(conv.bias, (pm.head_tp_shard(
                    prefix + "bias", conv.bias.shape, mesh.num_model, mesh.model_index),))
                x = conv2d(pm.copy_to_model(mesh, x), w, b, conv.stride, conv.padding,
                           conv.dtype)
                split = True
            else:
                if not split:
                    x = pm.scatter_to_model(mesh, x)
                x = pm.reduce_from_model(mesh, conv2d(x, w, None, conv.stride, conv.padding,
                                                      conv.dtype))
                x = x + conv.bias.to(conv.dtype)[None, :, None, None]
                split = False
        return pm.gather_from_model(mesh, x) if split else x


class RegressionHead(_Head):
    flax_name = "regression_head"

    def __init__(self, num_anchors: int = 9, channels: int = 256,
                 num_layers: int = 4, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_anchors * 4, channels, num_layers, dtype,
                         generator, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x)
        return _flatten(self.output(F.relu(x) if self.num_layers else x), 4)


class ClassificationHead(_Head):
    flax_name = "classification_head"

    def __init__(self, num_classes: int, num_anchors: int = 9,
                 channels: int = 256, num_layers: int = 4,
                 prior: float = 0.01, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_anchors * num_classes, channels, num_layers,
                         dtype, generator, -math.log((1.0 - prior) / prior))
        self.num_classes = num_classes

    def extract_feature(self, x: torch.Tensor) -> torch.Tensor:
        """Trunk features: the last conv's output before its ReLU."""
        return self.trunk(x)

    def classify(self, feat: torch.Tensor, enable_act: bool = True) -> torch.Tensor:
        """ReLU + output conv (+ sigmoid) -> (B, H*W*A, C)."""
        out = _flatten(self.output(F.relu(feat)), self.num_classes)
        return torch.sigmoid(out) if enable_act else out

    def forward(self, x: torch.Tensor, enable_act: bool = True) -> torch.Tensor:
        return self.classify(self.extract_feature(x), enable_act)
