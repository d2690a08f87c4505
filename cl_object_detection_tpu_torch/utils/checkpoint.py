"""Checkpoints with the JAX package's layout, retention and resume rules,
in a torch format of the port's own.

  * one checkpoint per (state, epoch):
    ``<root>/<scenario>/state<k>/epoch<e>/`` holding ``state.pt``
    (``torch.save`` of ``{"model": state dict, "optimizer": state dict,
    "step": micro-steps}``, every tensor on the CPU) and, when given,
    ``il_meta.json`` (the IL side metadata: exemplar ids, class lists,
    the state index, the loss window);
  * ``latest_epoch`` finds the newest epoch, ``nearest_epoch`` the newest
    at or below a bound;
  * ``auto_delete`` keeps epoch % keep_every == 0 plus the current epoch;
  * JSON and npz sidecars per state directory for the IL tools' outputs.

A save writes into a hidden directory that is renamed into place when it
is complete, so a reader never sees a partial checkpoint. With
``async_save`` the tensors are copied to the host first, in the caller's
thread (the next step cannot change what is written), and the write runs
in a thread; ``wait()`` joins it and re-raises its error. At most one
save is in flight.

On the mesh's data axis (``mesh=``, more than one rank) only rank 0
writes (checkpoints, sidecars, directories) and deletes; a save is
synchronous, so that no collective runs in a writer thread, and every
save, sidecar save and ``wait()`` ends in a barrier, so that no rank reads
before rank 0's write is complete. Every rank enters ``save``: where the
ranks keep blocks of the Adam moments (the model axis, ZeRO-1) the
optimizer's ``state_dict`` gathers them from both axes (a collective, on
the caller's thread, never the writer's), so the file holds whole
moments, bit for bit those of a run without ZeRO-1, and loads on any
mesh or in one process, each rank keeping its blocks. Every
rank reads (``restore``, ``epochs``, the sidecars); reading calls no
collective.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def scenario_tag(scenario) -> str:
    return "_".join(str(s) for s in scenario)


def host_copy(tree):
    """A copy of ``tree`` (dicts, lists, tuples, tensors, plain values)
    with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, root: str, scenario, keep_every: int = 5, mesh=None):
        from ..parallel.mesh import active, is_primary

        self.root = os.path.abspath(root)
        self.scenario_dir = os.path.join(self.root, scenario_tag(scenario))
        self.keep_every = keep_every
        self.mesh = mesh if active(mesh) else None
        self.primary = is_primary(mesh)
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        if self.primary:
            os.makedirs(self.scenario_dir, exist_ok=True)

    def _barrier(self) -> None:
        from ..parallel.mesh import barrier

        barrier(self.mesh)

    # ------------------------------------------------------------------
    def state_dir(self, state: int) -> str:
        d = os.path.join(self.scenario_dir, f"state{state}")
        if self.primary:
            os.makedirs(d, exist_ok=True)
        return d

    def epoch_dir(self, state: int, epoch: int) -> str:
        return os.path.join(self.state_dir(state), f"epoch{epoch}")

    def epochs(self, state: int) -> List[int]:
        self._join()
        d = self.state_dir(state)
        out = []
        for name in (os.listdir(d) if os.path.isdir(d) else ()):
            m = re.fullmatch(r"epoch(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_epoch(self, state: int) -> Optional[int]:
        eps = self.epochs(state)
        return eps[-1] if eps else None

    def nearest_epoch(self, state: int, upto: int) -> Optional[int]:
        """Newest saved epoch <= ``upto``: the resume fallback when the
        exact checkpoint was skipped by ``save_every`` or pruned."""
        eps = [e for e in self.epochs(state) if e <= upto]
        return eps[-1] if eps else None

    # ------------------------------------------------------------------
    def wait(self) -> None:
        """Block until an in-flight async save has finished, and re-raise
        its error if it failed; on the mesh, then a barrier."""
        self._join()
        self._barrier()

    def _join(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise err

    def save(
        self,
        state: int,
        epoch: int,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        step: int,
        il_meta: Optional[Dict[str, Any]] = None,
        async_save: bool = False,
    ) -> str:
        """Persist one (state, epoch) checkpoint; returns its directory."""
        self._join()
        path = self.epoch_dir(state, epoch)
        # every rank, on this thread: on the mesh the optimizer's state
        # dict gathers the ranks' moment blocks (a collective)
        opt_state = optimizer.state_dict()
        if not self.primary:
            self._barrier()
            return path
        tree = host_copy({"model": model.state_dict(), "optimizer": opt_state,
                          "step": int(step)})
        tmp = os.path.join(self.state_dir(state), f".tmp_epoch{epoch}")

        def write():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            torch.save(tree, os.path.join(tmp, STATE_FILE))
            if il_meta is not None:
                with open(os.path.join(tmp, "il_meta.json"), "w") as f:
                    json.dump(il_meta, f, indent=2, default=_jsonable)
            # delete the existing epoch only once the replacement is
            # complete: a crash during the write must not lose both
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)

        if not async_save or self.mesh is not None:
            try:
                write()
            finally:
                self._barrier()
            return path

        def work():
            try:
                write()
            except BaseException as e:  # surfaced by the next wait()
                self._pending_error = e
                shutil.rmtree(tmp, ignore_errors=True)

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()
        return path

    def restore(self, state: int, epoch: int = -1):
        """epoch=-1 locates the newest. Returns (tree, il_meta): ``tree``
        is ``{"model", "optimizer", "step"}`` with CPU tensors."""
        self._join()
        if epoch == -1:
            epoch = self.latest_epoch(state)
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints for state {state}")
        path = self.epoch_dir(state, epoch)
        tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)
        meta_path = os.path.join(path, "il_meta.json")
        il_meta = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                il_meta = json.load(f)
        return tree, il_meta

    # ------------------------------------------------------------------
    def auto_delete(self, state: int, current_epoch: int) -> None:
        """Keep epoch % keep_every == 0 and the current epoch (rank 0
        deletes)."""
        if not self.primary:
            return
        for e in self.epochs(state):
            if e == current_epoch or e % self.keep_every == 0:
                continue
            if e < current_epoch:
                shutil.rmtree(self.epoch_dir(state, e), ignore_errors=True)

    def save_sidecar(self, state: int, name: str, obj: Any) -> str:
        """JSON sidecar in the state directory."""
        path = os.path.join(self.state_dir(state), name + ".json")
        try:
            if self.primary:
                with open(path, "w") as f:
                    json.dump(obj, f, default=_jsonable)
        finally:
            self._barrier()
        return path

    def load_sidecar(self, state: int, name: str) -> Optional[Any]:
        path = os.path.join(self.state_dir(state), name + ".json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save_array_sidecar(self, state: int, name: str,
                           arrays: Mapping[str, Any]) -> str:
        """npz sidecar of named arrays or tensors (MAS importance,
        prototype features)."""
        path = os.path.join(self.state_dir(state), name + ".npz")
        try:
            if self.primary:
                np.savez(path, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                  else np.asarray(v) for k, v in arrays.items()})
        finally:
            self._barrier()
        return path

    def load_array_sidecar(self, state: int, name: str) -> Optional[Dict[str, np.ndarray]]:
        path = os.path.join(self.state_dir(state), name + ".npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as data:
            return {k: data[k] for k in data.files}


def _jsonable(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not jsonable: {type(o)}")
