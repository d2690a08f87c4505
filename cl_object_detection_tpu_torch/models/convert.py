"""Weight import from torchvision ResNets and from reference-trained
RetinaNet checkpoints (the JAX package's ``models/convert.py``).

The port keeps the flax module names, so a torch state dict maps onto it
by renaming alone (both are OIHW):

  conv1 / bn1                   -> backbone.conv1 / backbone.bn1
  layer{s}.{i}.conv{k} / bn{k}  -> backbone.layer{s}_{i}.conv{k} / bn{k}
  layer{s}.{i}.downsample.0 / 1 -> backbone.layer{s}_{i}.downsample_conv / _bn
  fpn.P5_1 P5_2 P4_1 P4_2 P3_1 P3_2 P6 P7_2
                                -> fpn.p5_lateral p5_smooth p4_lateral
                                   p4_smooth p3_lateral p3_smooth p6 p7
  regressionModel.conv{k} / output     -> regression_head.conv{k} / output
  classificationModel.conv{k} / output -> classification_head.conv{k} / output

BN ``weight``/``bias``/``running_mean``/``running_var`` keep their names
(``FrozenBN``); ``num_batches_tracked`` and a classifier's ``fc.*`` are
skipped by name. Loading is strict, like ``models/bridge.load_jax_variables``:
every port tensor of the loaded part (the backbone, or the whole model)
is set exactly once, every source key is used or skipped by name, and a
shape mismatch raises; a source key that maps to no port tensor is
named in the skipped list. Both output convs use the anchor-major channel
layout (channel = anchor * C + class), so they copy through.

A ``.pt``/``.pth`` loads with ``weights_only=True``; anything that needs
full unpickling (which runs code from the file) loads only with
``allow_pickle=True`` (CLI: ``--trust_torch_ckpt``). A flat ``.npz`` of
the same keys (``torch_to_npz``) loads anywhere.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..train.optim import set_learning_rate

_FPN_KEY_MAP = {
    "P5_1": "p5_lateral", "P5_2": "p5_smooth",
    "P4_1": "p4_lateral", "P4_2": "p4_smooth",
    "P3_1": "p3_lateral", "P3_2": "p3_smooth",
    "P6": "p6", "P7_2": "p7",
}
_HEAD_KEY_MAP = {"regressionModel": "regression_head",
                 "classificationModel": "classification_head"}
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def torch_to_npz(state_dict_path: str, out_path: str, allow_pickle: bool = False) -> None:
    """A torch state dict (or a reference checkpoint dict holding
    ``model_state_dict``) -> flat npz of numpy arrays."""
    np.savez(out_path, **_load_state_dict(state_dict_path, allow_pickle))


def _torch_load(path: str, allow_pickle: bool):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # the weights-only unpickler's refusal
        if not allow_pickle:
            raise ValueError(
                f"{path} is not a tensors-only state dict (weights_only load "
                f"failed: {e}); if you trust this file, pass allow_pickle=True "
                "(CLI: --trust_torch_ckpt) to permit full unpickling, which "
                "executes code embedded in the file") from e
        return torch.load(path, map_location="cpu", weights_only=False)


def _load_state_dict(path: str, allow_pickle: bool = False) -> Dict[str, np.ndarray]:
    """Read a torch ``.pt``/``.pth`` (optionally a reference checkpoint
    dict holding ``model_state_dict``) or a flat ``.npz``."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    raw = _torch_load(path, allow_pickle)
    if isinstance(raw, dict) and "model_state_dict" in raw:
        raw = raw["model_state_dict"]
    if hasattr(raw, "state_dict"):
        raw = raw.state_dict()
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in raw.items()}


def _backbone_name(key: str) -> str:
    """torchvision ResNet key -> port name under ``backbone.``."""
    parts = key.split(".")
    if parts[0] == "conv1" and parts[1:] == ["weight"]:
        return "backbone.conv1.weight"
    if parts[0] == "bn1" and len(parts) == 2 and parts[1] in _BN_LEAVES:
        return f"backbone.bn1.{parts[1]}"
    if parts[0].startswith("layer") and len(parts) >= 4:
        block = f"backbone.{parts[0]}_{parts[1]}"
        rest = parts[2:]
        if rest[0].startswith("conv") and rest[1:] == ["weight"]:
            return f"{block}.{rest[0]}.weight"
        if rest[0].startswith("bn") and len(rest) == 2 and rest[1] in _BN_LEAVES:
            return f"{block}.{rest[0]}.{rest[1]}"
        if rest[0] == "downsample" and rest[1:] == ["0", "weight"]:
            return f"{block}.downsample_conv.weight"
        if rest[0] == "downsample" and rest[1] == "1" and len(rest) == 3 \
                and rest[2] in _BN_LEAVES:
            return f"{block}.downsample_bn.{rest[2]}"
    raise KeyError(key)


def _full_name(key: str) -> str:
    """Reference RetinaNet key -> port name."""
    parts = key.split(".")
    if parts[0] == "fpn" and len(parts) == 3 and parts[1] in _FPN_KEY_MAP \
            and parts[2] in ("weight", "bias"):
        return f"fpn.{_FPN_KEY_MAP[parts[1]]}.{parts[2]}"
    if parts[0] in _HEAD_KEY_MAP and len(parts) == 3 \
            and (parts[1].startswith("conv") or parts[1] == "output") \
            and parts[2] in ("weight", "bias"):
        return f"{_HEAD_KEY_MAP[parts[0]]}.{parts[1]}.{parts[2]}"
    return _backbone_name(key)


def _is_skipped(key: str, backbone_only: bool) -> bool:
    return key.endswith("num_batches_tracked") or (backbone_only and key.startswith("fc."))


def _load_into(model: torch.nn.Module, sd: Dict[str, np.ndarray], rename,
               prefix: str, backbone_only: bool, strict: bool = True) -> Tuple[int, List[str]]:
    """Set the port tensors named ``prefix``* from ``sd`` through
    ``rename``; returns (loaded, skipped source keys: the ones skipped by
    name, then those that map to no port tensor)."""
    state = model.state_dict()
    incoming: Dict[str, np.ndarray] = {}
    skipped, unknown = [], []
    for key, value in sd.items():
        if _is_skipped(key, backbone_only):
            skipped.append(key)
            continue
        try:
            name = rename(key)
        except KeyError:
            unknown.append(key)
            continue
        if name not in state:
            unknown.append(key)
            continue
        if name in incoming:
            raise ValueError(f"two source keys map to {name}")
        arr = np.asarray(value, np.float32)
        if tuple(state[name].shape) != arr.shape:
            raise ValueError(f"shape mismatch for {key}: checkpoint {arr.shape} vs model "
                             f"{tuple(state[name].shape)} (wrong depth or num_classes?)")
        incoming[name] = arr
    missing = sorted(n for n in state if n.startswith(prefix) and n not in incoming)
    if missing and strict:
        raise ValueError(f"the checkpoint left {len(missing)} port tensors uninitialized "
                         f"(e.g. {missing[:5]}); pass strict=False to allow a partial load")
    with torch.no_grad():
        for name, arr in incoming.items():
            state[name].copy_(torch.from_numpy(arr))
    return len(incoming), skipped + unknown


def load_pretrained_backbone(model: torch.nn.Module, path: str,
                             allow_pickle: bool = False) -> None:
    """Set the backbone of ``model`` from torchvision ResNet weights, in
    place (strict over the backbone; ``fc.*`` skipped by name)."""
    loaded, skipped = _load_into(model, _load_state_dict(path, allow_pickle),
                                 _backbone_name, "backbone.", backbone_only=True)
    print(f"pretrained backbone: loaded {loaded} tensors, skipped {len(skipped)}"
          + _named(skipped))


def load_reference_checkpoint(model: torch.nn.Module, path: str, strict: bool = True,
                              allow_pickle: bool = False) -> None:
    """Set every tensor of ``model`` from a reference-trained RetinaNet
    checkpoint, in place. ``strict=False`` allows a partial load."""
    loaded, skipped = _load_into(model, _load_state_dict(path, allow_pickle),
                                 _full_name, "", backbone_only=False, strict=strict)
    print(f"reference checkpoint: loaded {loaded} tensors, skipped {len(skipped)}"
          + _named(skipped))


def _named(keys: List[str]) -> str:
    return f" ({', '.join(keys[:6])}{', ...' if len(keys) > 6 else ''})" if keys else ""


# ---------------------------------------------------------------------------
# Optimizer / scheduler state (continue a reference experiment here)
# ---------------------------------------------------------------------------

_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def _index_to_name(ckp: Dict) -> Dict[int, str]:
    """Reference Adam global param index -> torch parameter name.

    The reference's Adam has two groups: group 0 every parameter whose
    name does not contain 'classificationModel.output' (in
    ``named_parameters`` order, the state dict's keys minus the BN
    buffers), group 1 ``classificationModel.output.{weight,bias}``. The
    saved ``param_groups[g]['params']`` hold their global indices."""
    names = [k for k in ckp["model_state_dict"].keys() if not k.endswith(_BUFFER_SUFFIXES)]
    g0 = [n for n in names if "classificationModel.output" not in n]
    g1 = [n for n in names if "classificationModel.output" in n]
    groups = ckp["optimizer_state_dict"]["param_groups"]
    if len(groups) != 2 or [len(g["params"]) for g in groups] != [len(g0), len(g1)]:
        raise ValueError(
            "optimizer_state_dict param_groups do not match the reference's two-group "
            f"Adam layout: got {[len(g['params']) for g in groups]} params per group vs "
            f"model-derived {[len(g0), len(g1)]}")
    out = {}
    for idx_list, name_list in zip((groups[0]["params"], groups[1]["params"]), (g0, g1)):
        out.update(dict(zip(idx_list, name_list)))
    return out


def load_reference_optimizer(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                             path: str, allow_pickle: bool = False) -> Dict:
    """Set the port's Adam (``train.optim.Adam``) from a reference ``.pt``
    checkpoint's Adam moments and scheduler LR, in place.

    torch ``exp_avg``/``exp_avg_sq`` -> ``mu``/``nu`` (the same Adam),
    the largest ``step`` -> each group's ``count``; parameters the file
    holds no moments for start from zeros, as fresh Adam does. On the
    mesh each rank keeps its blocks of the whole moments. Returns
    ``{"step", "last_lr", "loaded", "skipped"}``. Raises ValueError if
    the file has no ``optimizer_state_dict``."""
    ckp = _torch_load(path, allow_pickle)
    if "optimizer_state_dict" not in ckp:
        raise ValueError(f"{path} has no optimizer_state_dict (model-only checkpoint?)")
    idx_to_name = _index_to_name(ckp)
    params = dict(model.named_parameters())
    moments = {n: {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
               for n, p in params.items()}
    loaded, skipped, steps = 0, [], [0]
    for idx, st in ckp["optimizer_state_dict"]["state"].items():
        name = idx_to_name.get(int(idx))
        try:
            port = _full_name(name) if name is not None else None
        except KeyError:
            port = None
        if port not in params:
            skipped.append(str(name if name is not None else idx))
            continue
        steps.append(int(st["step"]))
        for src, dst in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            arr = torch.as_tensor(st[src], dtype=torch.float32)
            if tuple(arr.shape) != tuple(params[port].shape):
                raise ValueError(f"optimizer moment shape mismatch for {name}: "
                                 f"{tuple(arr.shape)} vs {tuple(params[port].shape)}")
            moments[port][dst] = arr.to(params[port].device)
        loaded += 1
    count = max(steps)
    name_of = {id(p): n for n, p in params.items()}
    for group in optimizer.param_groups:
        group["count"] = count
        for p in group["params"]:
            # whole moments in, this rank's blocks kept on the mesh
            optimizer.set_moments(p, **moments[name_of[id(p)]])
    last_lr = None
    sched = ckp.get("scheduler_state_dict")
    if sched and sched.get("_last_lr"):
        last_lr = float(sched["_last_lr"][0])
        set_learning_rate(optimizer, last_lr)
    print(f"reference optimizer: grafted {loaded} moment pairs (step {count}), "
          f"skipped {len(skipped)}" + (f", lr {last_lr}" if last_lr is not None else ""))
    return {"step": count, "last_lr": last_lr, "loaded": loaded, "skipped": skipped}

