"""Weight bridge from the JAX package's variable tree to the port's model.

``load_jax_variables`` takes ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy arrays (what the JAX package's
``CheckpointManager.restore`` returns, after ``np.asarray``) and sets
every parameter and buffer of a port ``RetinaNet``. The port keeps the
flax module names, so the mapping is by rule:

  params/<path>/kernel           -> <path>.weight   (HWIO -> OIHW)
  params/<path>/bias             -> <path>.bias
  params/<path>/bn/scale         -> <path>.weight   (FrozenBN)
  params/<path>/bn/bias          -> <path>.bias
  batch_stats/<path>/bn/mean     -> <path>.running_mean
  batch_stats/<path>/bn/var      -> <path>.running_var

Coverage is strict: every port tensor is set exactly once and every JAX
leaf is used, or it raises naming the first few on each side.

``load_optax_state`` carries the Adam state of a JAX run onto the
port's optimizer (``train/optim.make_optimizer``) by the same rule, as
strictly: per group, the moments ``mu`` and ``nu`` (trees shaped like
``params``, holding that group's leaves), the step ``count`` and the
injected hyperparameters (``learning_rate``, ``b1``, ``b2``, ``eps``,
``eps_root``).

``save_npz`` / ``load_npz`` keep such a tree as a flat ``"/"``-keyed
``.npz`` (e.g. ``params/backbone/conv1/kernel``), the format
``cli/serve.py --weights`` reads. From a JAX run:
``np.savez("w.npz", **{"/".join(k): np.asarray(v) for k, v in
flatten(tree)})``, or ``save_npz`` of this module on the nested dict.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def port_name(path: Tuple[str, ...]) -> str:
    """The port's state_dict key of a flax leaf path
    (collection, module..., leaf)."""
    coll, *mods, leaf = path
    if len(mods) >= 2 and mods[-1] == "bn":
        suffix = _BN_LEAVES.get((coll, leaf))
        if suffix is None:
            raise KeyError(f"unexpected BatchNorm leaf {'/'.join(path)}")
        return ".".join(mods[:-1] + [suffix])
    if coll != "params" or leaf not in ("kernel", "bias"):
        raise KeyError(f"unexpected leaf {'/'.join(path)}")
    return ".".join(mods + ["weight" if leaf == "kernel" else "bias"])


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy a JAX variable tree into ``model`` in place (strict)."""
    state = model.state_dict()
    incoming: Dict[str, np.ndarray] = {}
    for path, val in _flatten(variables):
        name = port_name(path)
        if name in incoming:
            raise ValueError(f"two JAX leaves map to {name}")
        incoming[name] = _port_array(val)
    missing = sorted(set(state) - set(incoming))
    extra = sorted(set(incoming) - set(state))
    if missing or extra:
        raise ValueError(
            f"JAX variables do not match the model: {len(missing)} port "
            f"tensors have no JAX leaf (e.g. {missing[:5]}), {len(extra)} "
            f"JAX leaves have no port tensor (e.g. {extra[:5]})")
    with torch.no_grad():
        for name, arr in incoming.items():
            dst = state[name]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{name}: JAX shape {arr.shape} != port "
                                 f"shape {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(arr))


def _port_array(val) -> np.ndarray:
    """A float32 copy in the port's layout (HWIO -> OIHW)."""
    arr = np.asarray(val)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return np.array(arr, dtype=np.float32, order="C")


def load_optax_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     state: Mapping) -> None:
    """Set ``optimizer``'s Adam state (``train.optim.Adam``) from a JAX
    run's, in place (strict).

    ``state`` is ``{group: {"count": n, "learning_rate": lr, "b1": b1,
    "b2": b2, "eps": eps, "eps_root": 0, "mu": tree, "nu": tree}}`` for
    the groups ``backbone`` and ``output``, nested numpy, each tree keyed
    like ``params`` and holding the group's leaves. Every parameter gets
    its moments exactly once and every leaf is used, or it raises; the
    port's Adam has no ``eps_root``, so it must be 0. Under ZeRO-1 each
    rank keeps its slices of the whole moments."""
    names = {id(p): n for n, p in model.named_parameters()}
    groups = {g["name"]: g for g in optimizer.param_groups}
    if set(state) != set(groups):
        raise ValueError(f"optimizer groups {sorted(groups)} != JAX groups {sorted(state)}")
    expected = {"count", "learning_rate", "b1", "b2", "eps", "eps_root", "mu", "nu"}
    staged = []
    for gname, gstate in state.items():
        if set(gstate) != expected:
            raise ValueError(f"group {gname}: keys {sorted(gstate)} != {sorted(expected)}")
        if float(gstate["eps_root"]) != 0.0:
            raise ValueError(f"group {gname}: eps_root {gstate['eps_root']} != 0")
        members = {names[id(p)]: p for p in groups[gname]["params"]}
        moments = {}
        for key in ("mu", "nu"):
            got: Dict[str, np.ndarray] = {}
            for path, val in _flatten(gstate[key]):
                name = port_name(("params",) + path)
                if name in got:
                    raise ValueError(f"group {gname}: two {key} leaves map to {name}")
                got[name] = _port_array(val)
            missing, extra = sorted(set(members) - set(got)), sorted(set(got) - set(members))
            if missing or extra:
                raise ValueError(
                    f"group {gname} {key}: {len(missing)} params have no JAX leaf (e.g. "
                    f"{missing[:5]}), {len(extra)} JAX leaves have no param of the "
                    f"group (e.g. {extra[:5]})")
            for name, p in members.items():
                if got[name].shape != tuple(p.shape):
                    raise ValueError(f"{name} {key}: JAX shape {got[name].shape} != port "
                                     f"shape {tuple(p.shape)}")
            moments[key] = got
        staged.append((groups[gname], gstate, members, moments))
    for group, gstate, members, moments in staged:
        group["count"] = int(gstate["count"])
        group["lr"] = float(gstate["learning_rate"])
        group["betas"] = (float(gstate["b1"]), float(gstate["b2"]))
        group["eps"] = float(gstate["eps"])
        for name, p in members.items():
            # whole moments in, this rank's slices kept under ZeRO-1
            optimizer.set_moments(p, *(torch.from_numpy(moments[key][name])
                                       for key in ("mu", "nu")))


def save_npz(path: str, variables: Mapping) -> None:
    """Write a nested variable tree as a flat ``"/"``-keyed ``.npz``."""
    np.savez(path, **{"/".join(p): np.asarray(v) for p, v in _flatten(variables)})


def load_npz(path: str) -> Dict:
    """Read a flat ``"/"``-keyed ``.npz`` back into a nested dict."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *mods, leaf = key.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = data[key]
    return tree
