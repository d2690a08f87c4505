"""ResNet backbones (18/34/50/101/152) with permanently frozen BN.

The port of the JAX package's ``models/resnet.py``: 7x7/2 stem -> BN ->
ReLU -> 3x3/2 max-pool -> 4 residual stages (BasicBlock for 18/34,
Bottleneck with the stride on the 3x3 for 50/101/152); returns
(C3, C4, C5). Modules and parameters carry the flax names
(``layer1_0.conv1``, ``downsample_conv``, ``bn1`` ...), so the weight
bridge (``models/bridge.py``) maps one tree onto the other by rule.

The backbone takes NHWC batches, as the JAX package does; inside, the
convs run on NCHW views of channels-last memory. Parameters are float32
and every op runs in ``dtype`` (bfloat16 on the card). The model trains
under grad (the BN statistics stay constant, scale and bias train) and
serves under ``torch.no_grad`` / ``torch.inference_mode``.
"""
from __future__ import annotations

import math
from contextvars import ContextVar
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.pool import phase_pool

DEPTH_LAYERS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def he_fan_out_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """normal(0, sqrt(2 / (kh*kw*cout))) in place on an OIHW weight."""
    cout, _, kh, kw = weight.shape
    std = math.sqrt(2.0 / (kh * kw * cout))
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator) * std)


# (convs, run): while set, ``Conv.forward`` of a module in ``convs``
# returns ``run(conv, x)``. ``ops.quant.quantized_apply`` sets it for the
# length of one call, in the calling thread only.
conv_override: ContextVar[Optional[Tuple[frozenset, Callable]]] = ContextVar(
    "conv_override", default=None)


class Conv(nn.Module):
    """A conv with a float32 OIHW ``weight`` (and optional ``bias``) that
    runs in ``dtype`` (flax ``nn.Conv`` with ``dtype``/``param_dtype``),
    or int8 under ``ops.quant.quantized_apply`` (``conv_override``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init: str = "he"):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        if init == "he":
            he_fan_out_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        override = conv_override.get()
        if override is not None:
            convs, run = override
            if self in convs:
                return run(self, x)
        return conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int, padding: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.conv2d`` of ``x``, ``weight`` and ``bias`` cast to ``dtype``. On
    the CPU in bfloat16 under grad, a strided conv over a 1x1 input runs in
    float32 and rounds its output to bfloat16: PyTorch's CPU bfloat16
    kernel gives that conv a wrong weight gradient (it reads uninitialized
    memory; ``fpn.p7`` on frames of 64 pixels, where P6 is 1x1)."""
    x, w = x.to(dtype), weight.to(dtype)
    b = None if bias is None else bias.to(dtype)
    if (dtype == torch.bfloat16 and x.device.type == "cpu" and torch.is_grad_enabled()
            and stride > 1 and tuple(x.shape[-2:]) == (1, 1)):
        return F.conv2d(x.float(), w.float(), None if b is None else b.float(), stride,
                        padding).to(dtype)
    return F.conv2d(x, w, b, stride, padding)


class FrozenBN(nn.Module):
    """Inference-mode BatchNorm over NCHW: trainable ``weight`` (flax
    ``scale``) and ``bias``, constant ``running_mean``/``running_var``
    buffers that nothing updates. Computes ``(x - mean) * (scale *
    rsqrt(var + 1e-5)) + bias`` in float32 and returns ``dtype``, as
    flax's BatchNorm does. Without grad (``torch.no_grad``,
    ``torch.inference_mode``) it runs three passes, the last writing
    straight into ``dtype``; under grad the same formula runs out of
    place (an ``out=`` add has no backward), to the same bits."""
    eps = 1e-5

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        if torch.is_grad_enabled():
            y = (x - self.running_mean.view(shape)) * mul.view(shape)
            return (y + self.bias.view(shape)).to(self.dtype)
        # three passes: the subtraction promotes x to float32 as it reads
        # it, and the last add writes its float32 sum straight into the
        # output dtype (the same rounding as a separate cast)
        y = torch.sub(x, self.running_mean.view(shape))
        y.mul_(mul.view(shape))
        return torch.add(y, self.bias.view(shape),
                         out=torch.empty_like(x, dtype=self.dtype))


class StemConv(nn.Module):
    """The 7x7/2 stem conv; ``weight`` keeps the (64, 3, 7, 7) layout of
    the reference kernel. Three input forms (NHWC):

    * ``(B, H, W, 3)``: the direct conv; returns NCHW conv output.
    * ``(B, H/2, W/2, 12)``: 2x2 space-to-depth; the conv runs
      phase-packed as one 5x5/2 conv with a (5,5,12,256) kernel derived
      from ``weight``, BN folded in; returns the NCHW phase-packed
      output (before ReLU).
    * ``(B, H/4, W/4, 64)``: 4x4 space-to-depth; the whole stem (conv +
      folded BN + ReLU + pool) runs as ``ops.stem_fused.stem_fused``;
      returns the pooled NHWC tensor.
    """

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(64, 3, 7, 7))
        he_fan_out_(self.weight, generator)

    def forward(self, x: torch.Tensor, bn_scale=None, bn_bias=None):
        c = x.shape[-1]
        if c == 3:
            return F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(self.dtype),
                             stride=2, padding=3)
        kernel = self.weight.permute(2, 3, 1, 0)               # HWIO
        if c == 64:
            from ..ops.stem_fused import pack_stem_kernel, stem_fused

            k3 = pack_stem_kernel((kernel * bn_scale).to(self.dtype))
            return stem_fused(x, k3, bn_bias.repeat(4))
        if c != 12:
            raise ValueError(f"stem input must have 3, 12 or 64 channels, got {c}")
        k = (kernel * bn_scale).to(self.dtype)
        # W4[t,u,(alpha,beta,c),o] = w'[2t+alpha, 2u+beta, c, o]
        kp = F.pad(k, (0, 0, 0, 0, 1, 0, 1, 0))                # (8,8,3,64)
        w4 = kp.reshape(4, 2, 4, 2, 3, 64).permute(0, 2, 1, 3, 4, 5)
        w4 = w4.reshape(4, 4, 12, 64)
        # K5 block (a,b) = W4 placed at offset (a,b) in the 5x5 grid
        k5 = torch.stack(
            [F.pad(w4, (0, 0, 0, 0, b, 1 - b, a, 1 - a))
             for a in range(2) for b in range(2)], dim=3).reshape(5, 5, 12, 256)
        xp = F.pad(x.permute(0, 3, 1, 2), (2, 1, 2, 1))
        y4 = F.conv2d(xp, k5.permute(3, 2, 0, 1), stride=2)
        return y4 + bn_bias.repeat(4).to(y4.dtype)[None, :, None, None]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int, dtype, generator):
        super().__init__()
        conv = lambda ci, co, k, s, p: Conv(ci, co, k, s, p, bias=False,
                                            dtype=dtype, generator=generator)
        self.conv1 = conv(cin, planes, 3, stride, 1)
        self.bn1 = FrozenBN(planes, dtype)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = FrozenBN(planes, dtype)
        self.has_downsample = cin != planes or stride != 1
        if self.has_downsample:
            self.downsample_conv = conv(cin, planes, 1, stride, 0)
            self.downsample_bn = FrozenBN(planes, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_downsample else x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, dtype, generator):
        super().__init__()
        conv = lambda ci, co, k, s, p: Conv(ci, co, k, s, p, bias=False,
                                            dtype=dtype, generator=generator)
        out_ch = planes * 4
        self.conv1 = conv(cin, planes, 1, 1, 0)
        self.bn1 = FrozenBN(planes, dtype)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = FrozenBN(planes, dtype)
        self.conv3 = conv(planes, out_ch, 1, 1, 0)
        self.bn3 = FrozenBN(out_ch, dtype)
        self.has_downsample = cin != out_ch or stride != 1
        if self.has_downsample:
            self.downsample_conv = conv(cin, out_ch, 1, stride, 0)
            self.downsample_bn = FrozenBN(out_ch, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_downsample else x)
        return F.relu(out + residual)


def _normalize_stats(mean, std, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 (mean, std) of the RGB (3), 2x2 space-to-depth
    (12) and 4x4 space-to-depth (64: 48 real channels, 16 zero pads that
    normalize to 0) layouts."""
    mean = torch.tensor(mean, dtype=torch.float32)
    std = torch.tensor(std, dtype=torch.float32)
    if c == 12:
        mean, std = mean.repeat(4), std.repeat(4)
    elif c == 64:
        mean = torch.cat([mean.repeat(16), torch.zeros(16)])
        std = torch.cat([std.repeat(16), torch.ones(16)])
    return mean, std


def _device_normalize(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                      dtype) -> torch.Tensor:
    """On-device ``(x/255 - mean)/std`` for uint8 NHWC batches, with the
    per-channel ``_normalize_stats`` of ``x``'s layout on ``x``'s device.
    Float input (normalized on the host) is only cast to ``dtype``."""
    if x.dtype != torch.uint8:
        return x.to(dtype)
    out = (x.to(torch.float32) / 255.0 - mean) / std
    return out.to(dtype)


class ResNetBackbone(nn.Module):
    """Stem + 4 stages on an NHWC batch; returns NCHW (C3, C4, C5)."""

    def __init__(self, depth: int = 50, dtype: torch.dtype = torch.float32,
                 input_mean=(0.485, 0.456, 0.406),
                 input_std=(0.229, 0.224, 0.225),
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        if depth not in DEPTH_LAYERS:
            raise ValueError(f"depth must be one of {sorted(DEPTH_LAYERS)}, got {depth}")
        self.depth, self.dtype, self.remat = depth, dtype, remat
        self.input_mean, self.input_std = tuple(input_mean), tuple(input_std)
        # the normalization constants of each input layout live on the
        # model's device (not in the state dict), so a uint8 batch needs
        # no host-to-device copy, which would wait for the stream
        for c in (3, 12, 64):
            m, s = _normalize_stats(self.input_mean, self.input_std, c)
            self.register_buffer(f"_norm_mean{c}", m, persistent=False)
            self.register_buffer(f"_norm_std{c}", s, persistent=False)
        kind, layers = DEPTH_LAYERS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = StemConv(dtype, generator)
        self.bn1 = FrozenBN(64, dtype)
        cin = 64
        self.stage_names = []
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            names = []
            for i in range(n):
                stride = (1 if stage == 0 else 2) if i == 0 else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block(cin, planes, stride, dtype, generator))
                cin = planes * block.expansion
                names.append(name)
            self.stage_names.append(names)

    def _bn_fold(self):
        """(scale, bias) of the frozen stem BN, probed as bn(1) - bn(0)
        and bn(0) in float32, as the JAX package folds it."""
        bn = self.bn1
        zeros = torch.zeros(1, 64, 1, 1, device=bn.weight.device)
        bias = self._bn_f32(zeros)
        scale = self._bn_f32(torch.ones_like(zeros)) - bias
        return scale, bias

    def _bn_f32(self, x):
        bn = self.bn1
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = (x - bn.running_mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        return (y + bn.bias.view(1, -1, 1, 1))[0, :, 0, 0]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        c = x.shape[-1]
        if c not in (3, 12, 64):
            raise ValueError(f"input must have 3, 12 or 64 channels, got {c}")
        x = _device_normalize(x, getattr(self, f"_norm_mean{c}"),
                              getattr(self, f"_norm_std{c}"), self.dtype)
        if c == 64:
            scale, bias = self._bn_fold()
            x = self.conv1(x, bn_scale=scale, bn_bias=bias).permute(0, 3, 1, 2)
        elif c == 12:
            scale, bias = self._bn_fold()
            y4 = F.relu(self.conv1(x, bn_scale=scale, bn_bias=bias))
            x = phase_pool(y4.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        # remat (flax nn.remat): under grad each residual block keeps only
        # its input and recomputes its activations in the backward
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for stage, names in enumerate(self.stage_names):
            for name in names:
                block = getattr(self, name)
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if stage >= 1:
                outs.append(x)
        c3, c4, c5 = outs
        return c3, c4, c5

    @staticmethod
    def stage_channels(depth: int) -> Tuple[int, int, int]:
        kind, _ = DEPTH_LAYERS[depth]
        mult = 1 if kind == "basic" else 4
        return (128 * mult, 256 * mult, 512 * mult)
