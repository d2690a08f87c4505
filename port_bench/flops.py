"""Analytic work of a configuration: every conv of a RetinaNet with its
shapes, counted from the configuration and the frame alone, so the count
is the same whatever implements the model (a folded BN or a new kernel
leaves it unchanged).

A conv of ``cin`` -> ``cout`` channels, kernel ``k``, on an output of
``ho x wo`` pixels does ``ho * wo * cout * cin * k * k`` multiply-adds
per image (2 operations each). Elementwise work (BN, ReLU, adds, pooling,
the post-processing) is left out: the count is the least work a
forward needs at the tensor cores' peak.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


@dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    hw_in: Tuple[int, int]
    hw_out: Tuple[int, int]
    int8: bool            # quantized under the int8 predict (all but stem and head outputs)

    @property
    def macs(self) -> int:
        return self.hw_out[0] * self.hw_out[1] * self.cout * self.cin * self.k * self.k


def _out(hw: Tuple[int, int], k: int, stride: int) -> Tuple[int, int]:
    pad = k // 2
    return tuple((x + 2 * pad - k) // stride + 1 for x in hw)


def convs(cfg: dict, num_classes: int, height: int, width: int,
          heads: bool = True) -> Iterator[Conv]:
    """Every conv of the configuration's forward at ``height x width``,
    in forward order (the heads once per pyramid level)."""
    hw = (height, width)
    stem_out = _out(hw, 7, 2)
    yield Conv("backbone.conv1", 3, 64, 7, 2, hw, stem_out, False)
    hw = _out(stem_out, 3, 2)                                  # the max-pool
    cin, c = 64, []
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), BLOCKS[cfg["depth"]])):
        for i in range(n):
            s = 2 if (i == 0 and stage > 0) else 1
            p = f"backbone.layer{stage + 1}_{i}"
            out = _out(hw, 3, s)
            yield Conv(p + ".conv1", cin, planes, 1, 1, hw, hw, True)
            yield Conv(p + ".conv2", planes, planes, 3, s, hw, out, True)
            yield Conv(p + ".conv3", planes, planes * 4, 1, 1, out, out, True)
            if i == 0:
                yield Conv(p + ".downsample_conv", cin, planes * 4, 1, s, hw, out, True)
            cin, hw = planes * 4, out
        if stage >= 1:
            c.append((cin, hw))
    (c3, hw3), (c4, hw4), (c5, hw5) = c
    f = cfg["fpn_channels"]
    hw6 = _out(hw5, 3, 2)
    hw7 = _out(hw6, 3, 2)
    for name, ci, k, s, hin, hout in (
            ("p5_lateral", c5, 1, 1, hw5, hw5), ("p5_smooth", f, 3, 1, hw5, hw5),
            ("p4_lateral", c4, 1, 1, hw4, hw4), ("p4_smooth", f, 3, 1, hw4, hw4),
            ("p3_lateral", c3, 1, 1, hw3, hw3), ("p3_smooth", f, 3, 1, hw3, hw3),
            ("p6", c5, 3, 2, hw5, hw6), ("p7", f, 3, 2, hw6, hw7)):
        yield Conv("fpn." + name, ci, f, k, s, hin, hout, True)
    if not heads:
        return
    a = cfg["num_anchors"]
    for level, lhw in zip((3, 4, 5, 6, 7), (hw3, hw4, hw5, hw6, hw7)):
        for head, out in (("regression_head", a * 4), ("classification_head", a * num_classes)):
            for i in range(cfg["head_layers"]):
                yield Conv(f"{head}.conv{i + 1}@P{level}", f, f, 3, 1, lhw, lhw, True)
            yield Conv(f"{head}.output@P{level}", f, out, 3, 1, lhw, lhw, False)


def forward_macs(cfg: dict, num_classes: int, height: int, width: int) -> int:
    """Multiply-adds of one image's forward."""
    return sum(c.macs for c in convs(cfg, num_classes, height, width))


def backbone_macs(depth: int, height: int, width: int) -> int:
    """Multiply-adds of the ResNet alone (stem and four stages)."""
    cfg = {"depth": depth, "fpn_channels": 256, "num_anchors": 9, "head_layers": 4}
    return sum(c.macs for c in convs(cfg, 1, height, width) if c.name.startswith("backbone."))


def predict_least_s(cfg: dict, num_classes: int, height: int, width: int, batch: int,
                    int8: bool, bf16_flops: float, int8_ops: float) -> float:
    """The least seconds one predict batch takes at the peak: the int8
    convs at the int8 rate under ``int8``, every other conv at the
    bfloat16 rate."""
    t = 0.0
    for c in convs(cfg, num_classes, height, width):
        t += 2.0 * c.macs * batch / (int8_ops if (int8 and c.int8) else bf16_flops)
    return t


def train_step_macs(cfg: dict, num_classes: int, num_past: int, height: int,
                    width: int) -> int:
    """Multiply-adds of one image's incremental micro-step: the student's
    forward, its backward (the input gradient and the weight gradient,
    each a forward's work, but no input gradient of the stem, whose input
    is the frame) and the frozen teacher's forward."""
    student: List[Conv] = list(convs(cfg, num_classes, height, width))
    stem = student[0].macs
    teacher = forward_macs(cfg, num_past, height, width)
    fwd = sum(c.macs for c in student)
    return fwd + (2 * fwd - stem) + teacher
