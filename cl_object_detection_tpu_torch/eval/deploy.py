"""Deployment artifacts (the JAX package's ``eval/deploy.py``): the
trained predict path frozen by ``torch.export`` into a program that runs
without the port's model code.

``cli.export`` traces checkpoint + architecture + post-process (decode,
top-k, NMS) into one ``ExportedProgram`` per device type, the weights in
the program's state, and ``cli.serve --from_export`` (or any caller of
``load_artifact``) serves it with no access to the checkpoint tree or
the model classes.

JAX's artifact is one serialized StableHLO program that carries its
Pallas kernels inside as custom calls, lowered for every platform asked
for. Here:

* the artifact is a directory with one ``predict.<device type>.pt2`` per
  platform (``torch.export.save``), each traced on that device, plus
  ``meta.json``; exporting for a device needs that device present;
* the kernels are ``torch.library`` operators (``ops/library.py``) that
  the program calls by name, so ``load_artifact`` imports that module
  (and nothing of ``models/``) before it loads a program. On the card
  the operators launch the kernels, which build from ``csrc/`` at first
  use, so a fresh process that only loads an artifact builds what it
  needs.

The artifact contract (``meta.json``) records what the serving side
needs to build input frames: canonical frame H/W, host-side layout
(RGB / 2x2 or 4x4 space-to-depth), transfer dtype, batch size and class
count. Exported programs are shape-static: one artifact per (batch,
frame).
"""
from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

ARTIFACT_META = "meta.json"
PLATFORMS = ("cuda", "cpu")


def artifact_blob(platform: str) -> str:
    """File name of the program exported for ``platform`` (a device type)."""
    return f"predict.{platform}.pt2"


@dataclasses.dataclass
class ServingBundle:
    """Everything needed to rebuild the trained predict path from a run
    directory (checkpoint tree + the ``params.json`` the trainer wrote).
    ``model`` holds the weights, on its device."""

    model: Any                # models.retinanet.RetinaNet
    mcfg: Any                 # ModelConfig
    height: int
    width: int
    num_classes: int
    s2d: bool                 # host 2x2 space-to-depth frames (s2d_stem)
    fused: bool               # host 4x4 space-to-depth frames (fused_stem)
    il_meta: Optional[Dict[str, Any]]

    def frame_shape(self) -> Tuple[int, int, int]:
        """Per-image host frame shape for this run's stem layout."""
        if self.s2d:
            return (self.height // 2, self.width // 2, 12)
        if self.fused:
            return (self.height // 4, self.width // 4, 64)
        return (self.height, self.width, 3)


def model_config_from_run(run_cfg: Mapping[str, Any], depth: Optional[int] = None):
    """The ``ModelConfig`` of a run's ``params.json`` (its ``model``
    section; lists become tuples), ``depth`` overriding its depth."""
    from ..config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    run_model = {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in run_cfg.get("model", {}).items() if k in fields}
    if depth is not None:
        run_model["depth"] = depth
    return ModelConfig(**run_model)


def _structure_diff(want: Mapping[str, torch.Tensor], have: Mapping[str, torch.Tensor]) -> str:
    """'' when ``have`` has ``want``'s keys and shapes, else counts and
    examples of the missing, unexpected and misshapen keys."""
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    shaped = sorted(k for k in set(want) & set(have)
                    if tuple(want[k].shape) != tuple(have[k].shape))
    if not (missing or extra or shaped):
        return ""
    return (f"{len(missing)} params missing from the checkpoint (e.g. {missing[:5]}), "
            f"{len(extra)} unexpected (e.g. {extra[:5]}), {len(shaped)} of another shape "
            f"(e.g. {[(k, tuple(have[k].shape), tuple(want[k].shape)) for k in shaped[:3]]})")


def load_serving_bundle(root_dir: str, scenario: Sequence[str], state: int,
                        epoch: int = -1, depth: Optional[int] = None,
                        device=None) -> ServingBundle:
    """Rebuild the trained architecture and weights from a run directory
    (``<root_dir>/checkpoint``, as the port's trainer writes it), on
    ``device`` (the card unless the caller asks for the CPU).

    The trainer writes ``params.json`` in the start state's directory
    only, so a later state falls back through earlier states' directories.
    The whole ``ModelConfig`` comes from it (depth alone does not fix
    ``fpn_channels`` or ``head_layers``). A checkpoint that does not
    match the rebuilt architecture (a ``--depth`` override, an edited
    ``params.json``) fails here with a structural diff."""
    from .. import resolve_device
    from ..config import DataConfig
    from ..models.retinanet import create_retinanet
    from ..utils.checkpoint import CheckpointManager

    device = resolve_device(device)
    ckpt = CheckpointManager(os.path.join(root_dir, "checkpoint"), scenario)
    tree, il_meta = ckpt.restore(state, epoch)
    num_classes = il_meta["num_classes"] if il_meta else 20

    run_cfg: Dict[str, Any] = {}
    for s in range(state, -1, -1):
        try:
            with open(os.path.join(ckpt.state_dir(s), "params.json")) as f:
                run_cfg = json.load(f)
            break
        except (OSError, ValueError):
            continue
    mcfg = model_config_from_run(run_cfg, depth)
    model = create_retinanet(mcfg, num_classes, device=device)
    diff = _structure_diff(model.state_dict(), tree["model"])
    if diff:
        raise ValueError(
            f"checkpoint does not match the reconstructed architecture (ModelConfig "
            f"depth={mcfg.depth}, num_classes={num_classes}): {diff} — check "
            f"params.json / --depth")
    model.load_state_dict(tree["model"])
    run_data = run_cfg.get("data", {})
    s2d = bool(run_data.get("s2d_stem", False))
    return ServingBundle(
        model=model,
        mcfg=mcfg,
        height=int(run_data.get("height", DataConfig.height)),
        width=int(run_data.get("width", DataConfig.width)),
        num_classes=num_classes,
        s2d=s2d,
        fused=bool(run_data.get("fused_stem", False)) and not s2d,
        il_meta=il_meta,
    )


def bic_correct_for_bundle(bundle: ServingBundle) -> Callable:
    """The checkpoint's BiC correction (``il.bic.bic_correct_from_meta``)
    with the per-state new-class counts of the run's scenario: a numeric
    entry adds that many classes, a named one 1. Raises ``ValueError``
    when the checkpoint carries no usable BiC state."""
    from ..il.bic import bic_correct_from_meta

    # il_meta["config"] is the TrainConfig.to_json() string
    raw_cfg = (bundle.il_meta or {}).get("config", "{}")
    cfg_dict = json.loads(raw_cfg) if isinstance(raw_cfg, str) else raw_cfg
    scenario = cfg_dict.get("il", {}).get("scenario", [])
    counts = [int(e) if str(e).isdigit() else 1 for e in scenario]
    correct = (bic_correct_from_meta(bundle.il_meta, counts, bundle.num_classes)
               if counts else None)
    if correct is None:
        raise ValueError("--bic: checkpoint carries no usable BiC state")
    return correct


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: the model as a submodule (its
    weights become the program's state) and ``predict`` around it,
    returning a plain dict so loaders need no NamedTuple."""

    def __init__(self, model: torch.nn.Module, predict: Callable):
        super().__init__()
        self.model = model
        self.predict = predict

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        det = self.predict(images)
        return {"boxes": det.boxes, "scores": det.scores,
                "labels": det.labels, "valid": det.valid}


def export_predict(bundle: ServingBundle, batch: int, score_thresh: float = 0.05,
                   topk_method: str = "exact", quantize: bool = False,
                   transfer_dtype: str = "uint8",
                   platforms: Optional[Sequence[str]] = None,
                   bic: bool = False) -> Tuple[Dict[str, bytes], Dict[str, Any]]:
    """Trace the whole predict path (``make_predict_fn`` with
    ``PredictConfig(score_thresh, topk_method, quantize)``, the NMS at its
    default) on a static ``(batch, *frame_shape)`` input through
    ``torch.export.export``; returns ``({platform: .pt2 bytes}, meta)``.

    ``platforms`` are device types (``cuda``, ``cpu``), default the
    bundle's; each is traced on that device, which must be present.
    ``bic`` bakes the checkpoint's BiC correction into the program. The
    program maps images ``(batch, *frame_shape)`` to ``{"boxes": (B,D,4),
    "scores": (B,D), "labels": (B,D), "valid": (B,D)}``."""
    from ..config import PredictConfig
    from .predictor import make_predict_fn

    home = next(bundle.model.parameters()).device
    platforms = list(platforms) if platforms else [home.type]
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}: the port exports for {PLATFORMS}")
        if p == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("exporting for platform 'cuda' needs a CUDA device, and "
                               "this process has none")
    bic_correct = bic_correct_for_bundle(bundle) if bic else None
    pcfg = PredictConfig(score_thresh=score_thresh, topk_method=topk_method,
                         quantize=quantize)
    frame = bundle.frame_shape()
    dtype = torch.uint8 if transfer_dtype == "uint8" else torch.float32
    blobs: Dict[str, bytes] = {}
    for p in platforms:
        model = bundle.model if p == home.type else copy.deepcopy(bundle.model).to(p)
        program = _Program(model, make_predict_fn(model, pcfg, bic_correct=bic_correct))
        example = torch.zeros((batch,) + frame, dtype=dtype, device=p)
        exported = torch.export.export(program, (example,), strict=False)
        # the example frames (21 MB at B=8, 640x1024) have no place in
        # the artifact
        exported.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        blobs[p] = buf.getvalue()
    meta = {
        "batch": batch,
        "frame_shape": list(frame),
        "height": bundle.height,
        "width": bundle.width,
        "s2d": bundle.s2d,
        "fused": bundle.fused,
        "transfer_dtype": transfer_dtype,
        "num_classes": bundle.num_classes,
        "score_thresh": score_thresh,
        "topk_method": topk_method,
        "quantize": quantize,
        "bic": bic_correct is not None,
        "depth": bundle.mcfg.depth,
        "platforms": platforms,
        "knowing_class_ids": (bundle.il_meta or {}).get("knowing_class_ids"),
    }
    return blobs, meta


def save_artifact(out_dir: str, blobs: Mapping[str, bytes], meta: Mapping[str, Any]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for platform, blob in blobs.items():
        with open(os.path.join(out_dir, artifact_blob(platform)), "wb") as f:
            f.write(blob)
    with open(os.path.join(out_dir, ARTIFACT_META), "w") as f:
        json.dump(meta, f, indent=1)


def load_artifact(out_dir: str, device=None):
    """Load an exported artifact for ``device`` (the card unless the
    caller asks for the CPU); returns ``(fn, meta)`` where
    ``fn(images) -> dict of numpy arrays``. Needs the operator library
    (``ops/library.py``) and no model code or checkpoint tree.

    The program runs under ``torch.inference_mode``: it was traced
    there, and ``FrozenBN``'s inference form adds with ``out=``, which
    autograd refuses on the loaded parameters (they require grad)."""
    from .. import resolve_device
    from ..ops import library  # noqa: F401  (registers the cldet operators)

    device = resolve_device(device)
    with open(os.path.join(out_dir, ARTIFACT_META)) as f:
        meta = json.load(f)
    if device.type not in meta["platforms"]:
        raise ValueError(f"the artifact in {out_dir} was exported for {meta['platforms']}, "
                         f"not {device.type}")
    program = torch.export.load(os.path.join(out_dir, artifact_blob(device.type))).module()

    def fn(images) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            out = program(torch.as_tensor(images).to(device))
            return {k: v.cpu().numpy() for k, v in out.items()}

    return fn, meta
