"""The typed configuration tree.

Own copies of every dataclass of the JAX package's ``config.py``
(``ModelConfig``, ``DataConfig``, ``PredictConfig``, ``FocalConfig``,
``ScheduleConfig``, ``WarmupConfig``, ``ILConfig`` with the method
configs it holds, ``MeshConfig`` and ``TrainConfig``) with the same
fields and defaults, and of its (de)serialization and dotted-path
overrides, so ``TrainConfig().to_json()`` is the JAX package's string
and a run's ``params.json`` reads into either package unchanged.
``MeshConfig`` is carried as data: the trainer refuses ``enabled``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


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
    topk_method: str = "exact"         # "exact" | "approx" (the exact
                                       # stable top-k of the float32
                                       # scores: lax.approx_max_k off
                                       # the TPU; ops/nms.py)
    bbox_std: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    quantize: bool = False             # int8 convs on the predict path
                                       # (ops/quant.py)


@dataclass(frozen=True)
class FocalConfig:
    """Focal-loss constants."""
    alpha: float = 0.25
    gamma: float = 2.0
    fg_iou: float = 0.5                # anchors with maxIoU >= fg are positive
    bg_iou: float = 0.4                # anchors with maxIoU < bg are negative
    bbox_std: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    smooth_l1_beta: float = 1.0 / 9.0


@dataclass(frozen=True)
class ScheduleConfig:
    """Optimizer and schedule."""
    lr: float = 1e-5
    scheduler_milestone: Tuple[int, ...] = (40,)   # epoch milestones
    scheduler_decay: float = 0.1
    grad_clip: float = 0.1
    every_iter: int = 2                # gradient accumulation factor
    new_state_epoch: int = 60          # epochs per incremental state
    beta1: float = 0.9
    beta2: float = 0.999
    classifier_lr_scale: float = 1.0   # second Adam group (output conv)


@dataclass(frozen=True)
class WarmupConfig:
    """Staged layer unfreezing: each stage trains ONLY
    'output' (the classification output conv), 'fpn' (both heads) or
    'resnet' (the FPN and both heads)."""
    warm_stage: int = 0
    warm_epoch: Tuple[int, ...] = (10, 10)
    warm_layers: Tuple[str, ...] = ("output", "resnet")


@dataclass(frozen=True)
class DistillConfig:
    """Frozen-teacher distillation."""
    enabled: bool = False
    logits: bool = False               # distill logits vs probabilities
    feat_weight: float = 1.0           # cosine feature loss over 5 FPN maps
    teacher_fg_thresh: float = 0.05    # teacher prob > t counts as teacher-fg


@dataclass(frozen=True)
class ReplayConfig:
    """Exemplar replay."""
    sample_num: int = 0                # exemplars per class; 0 = off
    sample_method: str = "herd"        # random | herd | prototype_herd
    prototype_herd_mode: str = "slots" # prototype_herd: "slots" | "classmean"
    sample_batch_size: int = 5
    mix_data: bool = False             # interleave replay into the epoch
    mix_data_start: int = 0
    beta_on_replay: float = 0.9        # Adam beta1 used on replay batches
    beta_on_where: str = "all"         # which param group gets the swap
    enhance_error: bool = False        # penalize new-class scores on replay
    enhance_error_method: str = "L2"   # L1 | L2 | L3
    herd_ratio_threshold: float = 0.25 # fg-area ratio filter


@dataclass(frozen=True)
class MASConfig:
    """Memory-Aware Synapses."""
    enabled: bool = False
    ratio: float = 1.0


@dataclass(frozen=True)
class AGEMConfig:
    """Averaged-GEM gradient projection."""
    enabled: bool = False
    refresh_every: int = 1             # micro-steps between replay gradients


@dataclass(frozen=True)
class BiCConfig:
    """Bias-correction layers."""
    enabled: bool = False
    ratio: float = 0.1                 # val:train split carved from streams
    lr: float = 1e-3
    epochs_per_round: int = 1


@dataclass(frozen=True)
class PseudoLabelConfig:
    """Old-model pseudo-labels on new-state images."""
    enabled: bool = False
    score_thresh: float = 0.7
    iou_thresh: float = 0.35
    max_labels_per_image: int = 32     # static capacity


@dataclass(frozen=True)
class PrototypeConfig:
    """Prototype feature anchoring."""
    loss: bool = False
    margin: float = 600.0              # L2 distance margin
    weight: float = 0.1
    start_epoch: int = 5


@dataclass(frozen=True)
class ILConfig:
    """Scenario and every continual-learning method switch."""
    scenario: Tuple[str, ...] = ("20",)
    shuffle_class: bool = False
    shuffle_seed: int = 0
    start_state: int = 0
    end_state: Optional[int] = None

    distill: DistillConfig = field(default_factory=DistillConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    mas: MASConfig = field(default_factory=MASConfig)
    agem: AGEMConfig = field(default_factory=AGEMConfig)
    bic: BiCConfig = field(default_factory=BiCConfig)
    pseudo: PseudoLabelConfig = field(default_factory=PseudoLabelConfig)
    prototype: PrototypeConfig = field(default_factory=PrototypeConfig)

    init_method: str = "mean"          # classifier expansion warm-start:
                                       # mean | large | onlyNegative | none
    scail: bool = False                # SCAIL classifier standardization
    classifier_loss: bool = False      # cosine-margin old-vs-new
    classifier_loss_delta: float = 0.5

    # focal-loss IL variants
    ignore_past_class: bool = False
    new_ignore_past_class: bool = False
    decrease_positive: float = 1.0
    decrease_positive_by_iou: bool = False
    enhance_on_new: bool = False
    ignore_gd: bool = False

    # loss clipping
    clip_loss: bool = True
    clip_cls_loss: float = 0.03
    clip_replay_cls_loss: float = 0.003

    final_correction: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of multi-device training (``parallel/mesh.py``):
    one process per device on ``torch.distributed``, the ranks a
    ``num_data x num_model`` grid in JAX's row-major order. Every batch
    splits over the data axis and the global batch's gradient is
    all-reduced over it; ``num_model > 1`` splits the head trunks' 3x3
    convs over the model axis (JAX's ``head_tp_spec``: column- and
    row-parallel). ``enabled=True`` makes the trainer, the IL tools and the
    evaluator run on the ranks of the process group (one rank when there
    is none); batch sizes (train and replay) must be multiples of
    ``num_data`` and ``fpn_channels`` of ``num_model``. ``zero1`` also
    shards the Adam moments over the data axis (ZeRO-1,
    ``train/optim.py``; a no-op without one). With ``enabled=False`` the
    other fields are ignored."""
    enabled: bool = False
    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1                 # -1: the devices // num_model
    num_model: int = 1
    zero1: bool = False                # shard the Adam moments over data


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    focal: FocalConfig = field(default_factory=FocalConfig)
    data: DataConfig = field(default_factory=DataConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    warmup: WarmupConfig = field(default_factory=WarmupConfig)
    il: ILConfig = field(default_factory=ILConfig)
    predict: PredictConfig = field(default_factory=PredictConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    seed: int = 0
    start_epoch: Optional[int] = None
    end_epoch: Optional[int] = None
    checkpoint_dir: str = "checkpoint"
    keep_every: int = 5                # retention: keep epoch%5==0 + latest
    save_every: int = 1                # checkpoint every N epochs (+ final)
    async_checkpoint: bool = True      # copy to the host, write in a thread
                                       # (atomic rename): the loop goes on
    record: bool = True                # metric recording (TSV/TensorBoard)
    profile_dir: Optional[str] = None  # torch.profiler trace of the SECOND
                                       # training epoch into this dir
    description: str = "None"
    debug: bool = False
    val_after_train: bool = False
    output_examplar: bool = True
    # seed this run from a reference .pt checkpoint: weights always; Adam
    # moments + scheduler LR too on a same-state resume (start_epoch > 1).
    # trust_torch_ckpt permits full unpickling, which executes code in
    # the file.
    torch_ckpt: Optional[str] = None
    trust_torch_ckpt: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "TrainConfig":
        return _from_dict(TrainConfig, json.loads(text))


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in d.items():
        if key not in hints:
            raise KeyError(f"unknown config field {cls.__name__}.{key}")
        f = hints[key]
        default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else None)
        if dataclasses.is_dataclass(default):
            kwargs[key] = _from_dict(type(default), value)
        elif isinstance(value, list):
            kwargs[key] = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def apply_overrides(cfg: TrainConfig, overrides: Sequence[Tuple[str, Any]]) -> TrainConfig:
    """Apply dotted-path overrides, e.g. ``("il.mas.enabled", True)``."""
    for path, value in overrides:
        cfg = _set_path(cfg, path.split("."), value)
    return cfg


def _set_path(node, parts, value):
    name = parts[0]
    if not hasattr(node, name):
        raise KeyError(f"unknown config path segment {name!r} on {type(node).__name__}")
    if len(parts) == 1:
        value = _coerce(getattr(node, name), value)
        return dataclasses.replace(node, **{name: value})
    child = _set_path(getattr(node, name), parts[1:], value)
    return dataclasses.replace(node, **{name: child})


def _coerce(current, value):
    if isinstance(value, str):
        if isinstance(current, bool):
            return value.lower() in ("1", "true", "yes", "t")
        if isinstance(current, int) and not isinstance(current, bool):
            return int(value)
        if isinstance(current, float):
            return float(value)
        if isinstance(current, tuple):
            items = [v for v in value.replace(",", " ").split() if v]
            if current and isinstance(current[0], int):
                return tuple(int(v) for v in items)
            if current and isinstance(current[0], float):
                return tuple(float(v) for v in items)
            return tuple(items)
    if isinstance(value, list):
        return tuple(value)
    return value
