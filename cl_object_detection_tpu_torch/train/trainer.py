"""The IL trainer (the JAX package's ``train/trainer.py``). This slice
carries the warm-stage gradient mask the train step takes; ``ILTrainer``
is ROADMAP §1 item 2."""
from __future__ import annotations

from typing import Dict, Optional

import torch

WARM_WHITE_LIST = {
    # which parameter-name prefixes TRAIN in each warm stage
    "output": ("classification_head.output.",),
    "fpn": ("classification_head.", "regression_head."),
    "resnet": ("fpn.", "classification_head.", "regression_head."),
}


def trainable_mask(model: torch.nn.Module,
                   warm_kind: Optional[str]) -> Optional[Dict[str, float]]:
    """1.0 for each trainable parameter and 0.0 for each frozen one, by
    name; None (no mask) outside warm stages. The step multiplies each
    gradient by its entry, as JAX multiplies by a tree of ones and
    zeros."""
    if warm_kind is None:
        return None
    allow = WARM_WHITE_LIST[warm_kind]
    return {name: 1.0 if name.startswith(allow) else 0.0
            for name, _ in model.named_parameters()}
