"""Plain float32 RetinaNet: ResNet (frozen BN) + FPN P3-P7 + the two heads.

The benchmark's own reference, written from the architecture's published
description (Lin et al. 2017, "Focal Loss for Dense Object Detection";
He et al. 2016 for the ResNet), in plain ``torch`` and NCHW. It imports
nothing of the program under test. Parameters are a flat ``name ->
tensor`` dict whose names and shapes follow ``param_specs`` (the
program's state-dict names, so one set of seeded weights feeds both).

``quant``: ``None`` for float32 convs; the number of positive levels of
symmetric quantization (127 for int8, 7 for int4) applied to every conv
but the stem and the two heads' output convs: per-output-channel weight
scales, one activation scale per conv call over the whole batch, round
half to even, clip, the integer product, then rescale and bias
(``quant_conv``); or ``"fp8"``: every conv's input and weight rounded to
float8 e4m3 under one scale each (``fp8_conv``), the lower precision of
a bfloat16 configuration's control.

``recompute``: under grad each residual block and each head's pass over
a level keep only their input and recompute their activations in the
backward (the same numbers, less memory: a global batch of 64 frames
fits on one card).

``fit_bn``: each frozen BN's statistics are first set, in place, to the
batch's mean and variance at its input (how the benchmark makes weights
whose activations keep their scale through the depth).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BN_EPS = 1e-5

Params = Dict[str, torch.Tensor]


def param_specs(depth: int, num_classes: int, fpn: int = 256, head_layers: int = 4,
                anchors: int = 9) -> "OrderedDict[str, Tuple[Tuple[int, ...], str]]":
    """Every parameter and frozen-BN statistic: name -> (shape, role).
    Roles: ``conv`` (OIHW weight), ``bias``, ``bn_weight``, ``bn_bias``,
    ``bn_mean``, ``bn_var``, ``cls_out``/``cls_out_bias`` and
    ``reg_out``/``reg_out_bias`` (the heads' output convs)."""
    s: "OrderedDict[str, Tuple[Tuple[int, ...], str]]" = OrderedDict()

    def bn(name, c):
        for key, role in (("weight", "bn_weight"), ("bias", "bn_bias"),
                          ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            s[f"{name}.{key}"] = ((c,), role)

    s["backbone.conv1.weight"] = ((64, 3, 7, 7), "conv")
    bn("backbone.bn1", 64)
    cin = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), BLOCKS[depth])):
        for i in range(n):
            p = f"backbone.layer{stage + 1}_{i}"
            s[f"{p}.conv1.weight"] = ((planes, cin, 1, 1), "conv")
            bn(f"{p}.bn1", planes)
            s[f"{p}.conv2.weight"] = ((planes, planes, 3, 3), "conv")
            bn(f"{p}.bn2", planes)
            s[f"{p}.conv3.weight"] = ((planes * 4, planes, 1, 1), "conv")
            bn(f"{p}.bn3", planes * 4)
            if i == 0:
                s[f"{p}.downsample_conv.weight"] = ((planes * 4, cin, 1, 1), "conv")
                bn(f"{p}.downsample_bn", planes * 4)
            cin = planes * 4
    c3, c4, c5 = 512, 1024, 2048
    for name, ci, k in (("p5_lateral", c5, 1), ("p5_smooth", fpn, 3), ("p4_lateral", c4, 1),
                        ("p4_smooth", fpn, 3), ("p3_lateral", c3, 1), ("p3_smooth", fpn, 3),
                        ("p6", c5, 3), ("p7", fpn, 3)):
        s[f"fpn.{name}.weight"] = ((fpn, ci, k, k), "conv")
        s[f"fpn.{name}.bias"] = ((fpn,), "bias")
    for head, out, role in (("regression_head", anchors * 4, "reg_out"),
                            ("classification_head", anchors * num_classes, "cls_out")):
        for i in range(head_layers):
            s[f"{head}.conv{i + 1}.weight"] = ((fpn, fpn, 3, 3), "conv")
            s[f"{head}.conv{i + 1}.bias"] = ((fpn,), "bias")
        s[f"{head}.output.weight"] = ((out, fpn, 3, 3), role)
        s[f"{head}.output.bias"] = ((out,), role + "_bias")
    return s


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, 3, H, W) float32 ``(x/255 - mean)/std``."""
    x = images.permute(0, 3, 1, 2).float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)[None, :, None, None]
    sd = torch.tensor(std, dtype=torch.float32, device=x.device)[None, :, None, None]
    return (x - m) / sd


def quantize(v: torch.Tensor, scale: torch.Tensor, levels: int) -> torch.Tensor:
    """clip(round_half_even(v / scale), -levels, levels), as float32."""
    return torch.clamp(torch.round(v / scale), -levels, levels)


def quant_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
               padding: int, levels: int) -> torch.Tensor:
    """Symmetric quantized conv: weight scale per output channel
    ``max(max|w[o]|, 1e-8) / levels``, activation scale over the whole
    tensor ``max(max|x|, 1e-8) / levels``, the integer product in float32
    (exact up to 2**24; a 3x3 conv over 256 channels can pass that by
    2x, a rounding of 6e-8 relative), rescaled by the product of the
    scales, plus the bias."""
    s_w = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-8) / levels
    s_x = torch.clamp_min(x.abs().amax(), 1e-8) / levels
    wq = quantize(w, s_w[:, None, None, None], levels)
    xq = quantize(x, s_x, levels)
    y = F.conv2d(xq, wq, None, stride, padding)
    y = y * (s_x * s_w)[None, :, None, None]
    return y if b is None else y + b[None, :, None, None]


def fp8_round(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to float8 e4m3 under the scale that maps its
    largest magnitude to 448, back in float32; the gradient passes
    straight through."""
    s = torch.clamp_min(v.detach().abs().amax(), 1e-12) / 448.0
    r = (v.detach() / s).to(torch.float8_e4m3fn).float() * s
    return v + (r - v).detach()


def fp8_conv(x, w, b, stride, padding):
    return F.conv2d(fp8_round(x), fp8_round(w), b, stride, padding)


class Net:
    """The reference forward over a parameter dict (module docstring)."""

    def __init__(self, params: Params, depth: int, num_classes: int,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 head_layers: int = 4, anchors: int = 9, quant=None, fit_bn: bool = False,
                 recompute: bool = False):
        self.p, self.depth, self.num_classes = params, depth, num_classes
        self.fit_bn, self.recompute = fit_bn, recompute
        self.mean, self.std = mean, std
        self.head_layers, self.anchors, self.quant = head_layers, anchors, quant

    def conv(self, x, name, stride=1, padding=0, float_only=False):
        w, b = self.p[name + ".weight"], self.p.get(name + ".bias")
        if self.quant == "fp8":
            return fp8_conv(x, w, b, stride, padding)
        if self.quant is not None and not float_only:
            return quant_conv(x, w, b, stride, padding, self.quant)
        return F.conv2d(x, w, b, stride, padding)

    def bn(self, x, name):
        p = self.p
        if self.fit_bn:     # set the statistics to this batch's, as training would
            p[name + ".running_mean"].copy_(x.mean(dim=(0, 2, 3)))
            p[name + ".running_var"].copy_(x.var(dim=(0, 2, 3)))
        scale = p[name + ".weight"] * torch.rsqrt(p[name + ".running_var"] + BN_EPS)
        return ((x - p[name + ".running_mean"][None, :, None, None]) * scale[None, :, None, None]
                + p[name + ".bias"][None, :, None, None])

    def bottleneck(self, x, name, stride):
        out = F.relu(self.bn(self.conv(x, name + ".conv1"), name + ".bn1"))
        out = F.relu(self.bn(self.conv(out, name + ".conv2", stride, 1), name + ".bn2"))
        out = self.bn(self.conv(out, name + ".conv3"), name + ".bn3")
        if name + ".downsample_conv.weight" in self.p:
            x = self.bn(self.conv(x, name + ".downsample_conv", stride), name + ".downsample_bn")
        return F.relu(out + x)

    def backbone(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = normalize(images, self.mean, self.std)
        x = self.conv(x, "backbone.conv1", 2, 3, float_only=True)
        x = F.relu(self.bn(x, "backbone.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, n in enumerate(BLOCKS[self.depth]):
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                name = f"backbone.layer{stage + 1}_{i}"
                if self.recompute and torch.is_grad_enabled():
                    x = checkpoint(self.bottleneck, x, name, stride, use_reentrant=False)
                else:
                    x = self.bottleneck(x, name, stride)
            if stage >= 1:
                outs.append(x)
        return outs

    def fpn(self, c3, c4, c5) -> List[torch.Tensor]:
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        p5 = self.conv(c5, "fpn.p5_lateral")
        p4 = self.conv(c4, "fpn.p4_lateral") + up(p5)
        p3 = self.conv(c3, "fpn.p3_lateral") + up(p4)
        p6 = self.conv(c5, "fpn.p6", 2, 1)
        p7 = self.conv(F.relu(p6), "fpn.p7", 2, 1)
        return [self.conv(p3, "fpn.p3_smooth", 1, 1), self.conv(p4, "fpn.p4_smooth", 1, 1),
                self.conv(p5, "fpn.p5_smooth", 1, 1), p6, p7]

    def head(self, x, name, per_cell):
        for i in range(self.head_layers):
            x = F.relu(self.conv(x, f"{name}.conv{i + 1}", 1, 1))
        out = self.conv(x, f"{name}.output", 1, 1, float_only=True)
        b = out.shape[0]
        # NCHW (B, A*per_cell, H, W) -> (B, H*W*A, per_cell): cell-major, anchor-minor
        return out.permute(0, 2, 3, 1).reshape(b, -1, per_cell)

    def forward_all(self, images: torch.Tensor):
        """(logits (B, N, C), box deltas (B, N, 4), [P3..P7])."""
        feats = self.fpn(*self.backbone(images))
        head = self.head
        if self.recompute and torch.is_grad_enabled():
            head = lambda *a: checkpoint(self.head, *a, use_reentrant=False)
        reg = torch.cat([head(f, "regression_head", 4) for f in feats], dim=1)
        cls = torch.cat([head(f, "classification_head", self.num_classes) for f in feats],
                        dim=1)
        return cls, reg, feats
