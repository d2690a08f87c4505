"""How the harness builds the program's objects from a configuration file."""
from __future__ import annotations

import torch


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from cl_object_detection_tpu_torch.config import ModelConfig

    return ModelConfig(depth=cfg["depth"], fpn_channels=cfg["fpn_channels"],
                       head_layers=cfg["head_layers"], num_anchors=cfg["num_anchors"],
                       prior=cfg["prior"], compute_dtype=cfg["compute_dtype"],
                       input_mean=tuple(cfg["input_mean"]), input_std=tuple(cfg["input_std"]))


def build_model(cfg: dict, num_classes: int, params, device):
    """The port's RetinaNet, built on ``device``, holding ``params``."""
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

    with torch.device(device):
        model = create_retinanet(model_config(cfg), num_classes, device=device)
    model.load_state_dict(params)
    return model
