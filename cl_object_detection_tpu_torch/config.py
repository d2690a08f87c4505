"""Configuration dataclasses of the serving path.

Own copies of ``ModelConfig``, ``DataConfig`` and ``PredictConfig`` from
the JAX package's ``config.py``, with the same fields and defaults, so a
run's ``params.json`` reads into either package unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """RetinaNet architecture knobs."""
    depth: int = 50                    # ResNet depth in {18,34,50,101,152}
    fpn_channels: int = 256            # FPN + head trunk width
    head_layers: int = 4               # 3x3 conv stack depth in each head
    num_anchors: int = 9               # 3 ratios x 3 scales per cell
    prior: float = 0.01                # classification bias init prior
    pyramid_levels: Tuple[int, ...] = (3, 4, 5, 6, 7)
    pretrained: Optional[str] = None   # path to converted backbone npz
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"    # activation dtype on the card
    input_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    input_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
                                       # on-device normalization stats for
                                       # uint8 input batches
    remat: bool = False                # activation recompute (training)


@dataclass(frozen=True)
class DataConfig:
    """Dataset + static-shape input pipeline."""
    root_dir: str = "."
    dataset: str = "voc2007"
    train_json: Optional[str] = None
    val_json: Optional[str] = None
    image_dir_train: Optional[str] = None
    image_dir_val: Optional[str] = None
    batch_size: int = 4
    min_side: int = 608
    max_side: int = 1024
    height: int = 640                  # canonical padded H
    width: int = 1024                  # canonical padded W
    max_boxes: int = 100               # GT padding capacity
    hflip_prob: float = 0.5
    shape_buckets: Tuple[Tuple[int, int], ...] = ()
    s2d_stem: bool = False             # 2x2 space-to-depth batches
                                       # (B,H/2,W/2,12)
    fused_stem: bool = False           # 4x4 space-to-depth batches
                                       # (B,H/4,W/4,64): the whole stem
                                       # runs as one fused kernel
                                       # (ops/stem_fused.py)
    transfer_dtype: str = "float32"    # "uint8": ship raw pixels and
                                       # normalize on the device
    use_data_ratio: float = 1.0
    num_workers: int = 2
    prefetch: int = 2
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class PredictConfig:
    """Detection post-processing."""
    score_thresh: float = 0.05
    nms_iou: float = 0.5
    pre_nms_topk: int = 1024           # static candidate capacity
    max_detections: int = 300          # static output capacity
    use_pallas_nms: bool = True        # ignored: nms_impl alone picks the
                                       # NMS; kept so a run's params.json
                                       # reads unchanged
    nms_impl: str = "iterative"        # "iterative" | "scan" |
                                       # "pallas_fp" (the batched NMS
                                       # kernel, ops/nms_fp.py); legacy
                                       # "pallas" aliases pallas_fp
    topk_method: str = "exact"         # "exact"; "approx" is not ported
    bbox_std: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    quantize: bool = False             # int8 predict path: not ported
