"""Train state (the JAX package's ``train/state.py``): the model, its
optimizer, the micro-step count and the gradient accumulator.

The accumulator is the parameters' ``.grad``: each micro-step's backward
adds its gradient there, and the train step clears it after each apply
(``train/step.py``). The frozen BN statistics are buffers of the model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0                       # micro-steps taken
    acc_count: int = 0                  # micro-steps since the last apply

    @property
    def grad_acc(self) -> Dict[str, torch.Tensor]:
        """The accumulated gradient by parameter name (zeros where no
        backward has reached a parameter since the last apply)."""
        return {n: torch.zeros_like(p) if p.grad is None else p.grad
                for n, p in self.model.named_parameters()}
