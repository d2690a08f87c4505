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

The mesh's blocks (``make_optimizer`` with a mesh whose model axis has
several ranks or whose ``zero1`` is on; JAX's ``shard_train_state``,
``zero1_extend_spec`` and ``make_param_constraint``): a shard plan per rank
(``parallel.mesh.shard_plans``) names each rank's block of every leaf it
splits: the model axis's slice of a head-trunk conv (``head_tp_shard``),
then, under ZeRO-1, the data axis's slice of a free dim (``zero1_shard``).
The rank keeps ``mu`` and ``nu`` of its blocks only (whole ones for the
leaves that stay whole), runs the same arithmetic on contiguous copies of
its blocks of the gradient and the parameter (Adam is elementwise, so
those bits equal the whole update's), writes them back, and
``parallel.mesh.param_all_gather`` reassembles every parameter from the
ranks' blocks. The groups' ``count``, LR and betas stay on every rank.
``state_dict`` gathers whole moments (a collective every rank calls), so a
checkpoint written on any mesh is bit-identical to one written in one
process from the same gradients and loads on any mesh;
``load_state_dict`` and ``set_moments`` keep this rank's blocks of whole
moments.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import ScheduleConfig
from ..parallel import mesh as pmesh

CLS_OUTPUT_PREFIX = "classification_head.output."


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """``'output'`` for the classification output conv's parameters,
    ``'backbone'`` for the rest, by parameter name."""
    return {name: "output" if name.startswith(CLS_OUTPUT_PREFIX) else "backbone"
            for name, _ in model.named_parameters()}


class Adam(torch.optim.Optimizer):
    """optax's Adam with injected ``lr``, ``b1`` and ``b2`` per group and
    a step ``count`` per group (module docstring). State per parameter:
    ``mu`` and ``nu``, of this rank's block under a shard plan.

    ``names`` maps every parameter to its name; ``plans`` (every rank's,
    by name, ``parallel.mesh.shard_plans``) and ``mesh`` split the
    moments."""

    def __init__(self, param_groups, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 names: Optional[Mapping[torch.Tensor, str]] = None,
                 plans: Optional[Sequence[Mapping[str, Optional[pmesh.Shard]]]] = None,
                 mesh: Optional[pmesh.DataMesh] = None):
        super().__init__(param_groups, dict(lr=lr, betas=betas, eps=eps, count=0))
        self.mesh = mesh
        self._names = dict(names or {})
        self._plans = list(plans or [{}])
        plan = self._plans[mesh.rank if len(self._plans) > 1 else 0]
        self._shards = {p: plan.get(self._names.get(p)) for g in self.param_groups
                        for p in g["params"]}
        self.sharded = any(s is not None for s in self._shards.values())

    def _shard(self, p: torch.Tensor) -> Optional[pmesh.Shard]:
        return self._shards.get(p)

    def _own(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of this rank's block of ``t`` (shaped like
        ``p``); ``t`` itself for a whole leaf."""
        shard = self._shard(p)
        return t if shard is None else pmesh.shard_of(t, shard).contiguous()

    def moment_bytes(self) -> int:
        """Bytes of ``mu`` and ``nu`` this rank keeps (of its blocks on the
        mesh), whether or not a step has made them yet."""
        return sum(2 * pmesh.shard_of(p, s).numel() * p.element_size()
                   for p, s in self._shards.items())

    def set_moments(self, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> None:
        """Set ``p``'s moments from whole ``mu`` and ``nu`` (this rank's
        blocks of them on the mesh), on ``p``'s device."""
        self.state[p] = {k: self._own(p, v.to(p.device, torch.float32)).clone()
                         for k, v in (("mu", mu), ("nu", nu))}

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
                    z = self._own(p, p)
                    self.state[p] = {"mu": torch.zeros_like(z), "nu": torch.zeros_like(z)}
            grads = [self._own(p, g) for p, g in zip(params, grads)]
            targets = [self._own(p, p) for p in params]
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
            torch._foreach_add_(targets, upd)
            for p, t in zip(params, targets):
                if t is not p:
                    pmesh.shard_of(p, self._shard(p)).copy_(t)
        if self.sharded:
            pmesh.param_all_gather(self.mesh, {self._names[p]: p for p in self._shards},
                                   self._plans)

    def state_dict(self):
        """torch's optimizer state dict with whole moments: on the mesh a
        collective (every rank calls it) that gathers the ranks' blocks."""
        sd = super().state_dict()
        if not self.sharded:
            return sd
        order = [p for g in self.param_groups for p in g["params"]]
        keys = [(i, k) for i, p in enumerate(order) if i in sd["state"]
                and self._shard(p) is not None for k in ("mu", "nu")]
        pieces = [(sd["state"][i][k], order[i].shape,
                   [plan[self._names[order[i]]] for plan in self._plans]) for i, k in keys]
        whole = pmesh.gather_shards(self.mesh, pieces) if pieces else []
        state = {i: dict(st) for i, st in sd["state"].items()}
        for (i, k), w in zip(keys, whole):
            state[i][k] = w
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, state_dict) -> None:
        """torch's, then this rank's blocks of the whole moments."""
        super().load_state_dict(state_dict)
        for p, st in list(self.state.items()):
            if self._shard(p) is not None and "mu" in st:
                self.set_moments(p, st["mu"], st["nu"])


def make_optimizer(cfg: ScheduleConfig, model: torch.nn.Module,
                   mesh: Optional[pmesh.DataMesh] = None) -> Adam:
    """Adam over ``model``'s parameters in the two groups, each group
    carrying its ``name``; on ``mesh`` (a model axis, or ZeRO-1), over this
    rank's blocks of the moments (module docstring)."""
    labels = param_labels(model)
    groups = []
    for name, lr in (("backbone", cfg.lr), ("output", cfg.lr * cfg.classifier_lr_scale)):
        params = [p for n, p in model.named_parameters() if labels[n] == name]
        groups.append({"name": name, "params": params, "lr": lr})
    named = list(model.named_parameters())
    return Adam(groups, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                names={p: n for n, p in named}, plans=pmesh.shard_plans(mesh, named), mesh=mesh)


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
