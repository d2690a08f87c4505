"""Two Adam groups, the MultiStep learning rate and the beta1 swap (the
JAX package's ``train/optim.py``, which builds them on optax).

``Adam`` is optax's ``inject_hyperparams(adam)`` written for PyTorch,
one param group per label:
  * ``output``: the classification output conv, at
    ``lr * classifier_lr_scale``;
  * ``backbone``: everything else, at ``lr``.

Per group, in float32 as optax computes it: ``count += 1``,
``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
``p += -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)``
with ``eps = 1e-8`` outside the square root, and the hyperparameters
rounded to float32 first (``1 - b2`` of a float32 ``b2 = 0.999`` is
0.000999987, not 0.001; ``torch.optim.Adam`` computes its constants in
double and so moves ``nu`` by 1.3e-5 relative). The learning rate and
the betas are group state the host swaps between steps
(``set_learning_rate``, ``set_beta1``), as ``inject_hyperparams`` makes
them state leaves; the bias correction uses the group's current betas
at the group's count, which all its parameters share. Every parameter
needs a gradient tensor at each step (zeros where masked): optax still
moves the moments, and a parameter Adam skipped would fall behind.

No clipping here and no accumulation: the train step owns both
(``train/step.py``), as the JAX trainer builds its optimizer with
``use_clip=False``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ScheduleConfig

CLS_OUTPUT_PREFIX = "classification_head.output."


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """``'output'`` for the classification output conv's parameters,
    ``'backbone'`` for the rest, by parameter name."""
    return {name: "output" if name.startswith(CLS_OUTPUT_PREFIX) else "backbone"
            for name, _ in model.named_parameters()}


class Adam(torch.optim.Optimizer):
    """optax's Adam with injected ``lr``, ``b1`` and ``b2`` per group and
    a step ``count`` per group (module docstring). State per parameter:
    ``mu`` and ``nu``."""

    def __init__(self, param_groups, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(param_groups, dict(lr=lr, betas=betas, eps=eps, count=0))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            grads = [p.grad for p in params]
            if any(g is None for g in grads):
                raise ValueError(f"group {group['name']}: every parameter needs a gradient "
                                 "tensor (zeros where masked), as optax moves every moment")
            for p in params:
                if p not in self.state:
                    self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            one = np.float32(1)
            b1, b2 = (np.float32(b) for b in group["betas"])
            group["count"] += 1
            count = np.float32(group["count"])
            # mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu
            torch._foreach_mul_(mus, float(b1))
            torch._foreach_add_(mus, torch._foreach_mul(grads, float(one - b1)))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, float(one - b2))
            torch._foreach_mul_(nus, float(b2))
            torch._foreach_add_(nus, sq)
            bc1 = float(one - np.power(b1, count, dtype=np.float32))
            bc2 = float(one - np.power(b2, count, dtype=np.float32))
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, float(np.float32(group["eps"])))
            upd = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
            torch._foreach_mul_(upd, float(-np.float32(group["lr"])))
            torch._foreach_add_(params, upd)


def make_optimizer(cfg: ScheduleConfig, model: torch.nn.Module) -> Adam:
    """Adam over ``model``'s parameters in the two groups, each group
    carrying its ``name``."""
    labels = param_labels(model)
    groups = []
    for name, lr in (("backbone", cfg.lr), ("output", cfg.lr * cfg.classifier_lr_scale)):
        params = [p for n, p in model.named_parameters() if labels[n] == name]
        groups.append({"name": name, "params": params, "lr": lr})
    return Adam(groups, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2))


def lr_at_epoch(cfg: ScheduleConfig, epoch: int) -> float:
    """MultiStepLR: decay by ``cfg.scheduler_decay`` at each milestone
    (the scheduler steps after each epoch, so epoch k counts the
    milestones strictly below k)."""
    lr = cfg.lr
    for m in cfg.scheduler_milestone:
        if epoch > m:
            lr *= cfg.scheduler_decay
    return lr


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float,
                      classifier_scale: float = 1.0) -> None:
    """Set the learning rate of both groups; ``output`` keeps its
    ``classifier_scale`` multiple."""
    for group in optimizer.param_groups:
        group["lr"] = lr * (classifier_scale if group["name"] == "output" else 1.0)


def set_beta1(optimizer: torch.optim.Optimizer, b1: float, where: str = "all") -> None:
    """Swap Adam's beta1 (replay batches). where: 'all' | 'output' |
    'feature' (the backbone group)."""
    target = {"all": None, "output": "output", "feature": "backbone"}[where]
    for group in optimizer.param_groups:
        if target is None or group["name"] == target:
            group["betas"] = (b1, group["betas"][1])


def get_hyperparams(optimizer: torch.optim.Optimizer) -> Dict[str, Dict[str, float]]:
    """{group: {"learning_rate", "b1", "b2"}}, optax's names."""
    return {g["name"]: {"learning_rate": float(g["lr"]), "b1": float(g["betas"][0]),
                        "b2": float(g["betas"][1])}
            for g in optimizer.param_groups}
