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
        arr = np.asarray(val)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)       # HWIO -> OIHW
        incoming[name] = arr
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
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)))


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
