"""What the measuring tools share: the ``--cpu`` flag, the seeded model
and the seeded input frames."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device

NUM_CLASSES = 20                 # VOC, as the JAX package's tools


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card; raises without CUDA)")


def device_of(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else None)


def no_tf32() -> None:
    """float32 figures are float32: no TF32 in cuDNN or cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_model(depth: int, device, dtype: str = "bfloat16", seed: int = 0, **cfg):
    """A RetinaNet of ``depth`` over the 20 VOC classes, weights from
    ``seed``, in eval mode on ``device``; ``cfg``: more ``ModelConfig``
    fields (``remat``, ...)."""
    from ..config import ModelConfig
    from ..models.retinanet import create_retinanet

    if dtype == "float32":
        no_tf32()
    gen = torch.Generator().manual_seed(seed)
    return create_retinanet(ModelConfig(depth=depth, compute_dtype=dtype, **cfg),
                            NUM_CLASSES, device=device, generator=gen)


def frames(batch: int, height: int, width: int, stem: str = "fused", seed: int = 0,
           uint8: bool = True) -> np.ndarray:
    """Seeded host frames for ``stem``: ``rgb`` (B, H, W, 3), ``s2d``
    (B, H/2, W/2, 12) or ``fused`` (B, H/4, W/4, 64); uint8 pixels (the
    serving and trainer transfer dtype, normalized on the card), or
    float32 ``randn * 0.1`` (already normalized)."""
    from ..data.transforms import space_to_depth

    r = np.random.RandomState(seed)
    if uint8:
        x = r.randint(0, 256, (batch, height, width, 3)).astype(np.uint8)
    else:
        x = (r.randn(batch, height, width, 3) * 0.1).astype(np.float32)
    if stem == "rgb":
        return x
    return space_to_depth(x, factor={"s2d": 2, "fused": 4}[stem])


def anchors(height: int, width: int, device) -> torch.Tensor:
    from ..ops.anchors import anchors_for_shape

    return torch.tensor(anchors_for_shape(height, width), device=device)
