"""Incremental-state micro-steps with distillation through the trainer.

The timed call is ``ILTrainer.run_batch(batch, sync_metrics=False)`` of
the port on ``data.loader.Batch`` objects that the harness makes from the
seed (the loader is bypassed; the trainer's pinned copy in stays). The
traffic's parameters (``traffic/<name>.json``): ``scenario`` (the class
split; the run trains its last state), ``batch`` (per rank), ``frame``,
``image``, ``ring`` (distinct seeded batches, fed in turn), the schedule
(``every_iter``, ``lr``, ``grad_clip``), the ground truth (``boxes``
per image in ``slots``, sides in ``box_side``, labels of the state's new
classes), ``student_spread`` (how far the student's weights lie from the
teacher's), ``check_steps`` (the first micro-steps, which the reference
follows) and ``trace_steps``.

Set-up makes the teacher's weights (the previous state's classes) and
the student's (the teacher's, moved by ``student_spread`` of each
leaf's spread, with new classifier rows) on the card, writes them as the
previous state's checkpoint and this state's epoch-1 checkpoint under
``TMPDIR``, and builds the trainer at this state's epoch 2, which reads
both: the student as a mid-state resume, the teacher as the previous
state's newest checkpoint. It then runs ``check_steps`` micro-steps
(distinct batches; the first applies, every shape), keeping each loss,
the Adam moments after the first apply and the parameters after the
last. The window runs micro-steps until ``--seconds`` have passed and the
card has finished them.

The check runs the reference's float32 steps from the same weights on
the same batches and compares (``compare.train_steps``).
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import compare, inputs, weights
from port_bench.reference import detect as ref_detect
from port_bench.reference import train as ref_train
from port_bench.reference.retinanet import param_specs

VOC = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair", "cow",
       "diningtable", "dog", "horse", "motorbike", "person", "pottedplant", "sheep", "sofa",
       "train", "tvmonitor")


def student_weights(teacher, cfg: dict, past: int, classes: int, seed: int, spread: float):
    """The student: every leaf of the teacher moved by ``spread`` times its
    own standard deviation of noise (the frozen-BN statistics unchanged),
    the classifier's output grown from ``past`` to ``classes`` rows per
    anchor with new rows of the old rows' spread and the prior's bias."""
    specs = param_specs(cfg["depth"], classes, cfg["fpn_channels"], cfg["head_layers"],
                        cfg["num_anchors"])
    dev = next(iter(teacher.values())).device
    g = torch.Generator(device=dev).manual_seed(inputs.sub_seed(seed, inputs.STUDENT))
    a, new = cfg["num_anchors"], classes - past
    out = {}
    for k, v in teacher.items():
        if k.startswith("classification_head.output."):
            old = v.reshape(a, past, *v.shape[1:])
            if k.endswith("weight"):
                extra = torch.randn((a, new) + tuple(v.shape[1:]), generator=g, device=dev)
                extra = extra * old.std()
            else:
                extra = weights.PRIOR_BIAS + 0.2 * torch.rand((a, new), generator=g,
                                                              device=dev) - 0.1
            v = torch.cat([old, extra], dim=1).reshape(specs[k][0])
        out[k] = v.clone()
    moved = [k for k in out if "running_" not in k]
    noise = torch.randn(sum(out[k].numel() for k in moved), generator=g, device=dev)
    at = 0
    for k in moved:
        n = out[k].numel()
        scale = float(out[k].std()) if n > 1 else abs(float(out[k]))
        out[k] += spread * scale * noise[at:at + n].view_as(out[k])
        at += n
    return out


def _dataset(workdir: str, h: int, w: int) -> str:
    """A one-image COCO file with the 20 classes, which the trainer's
    constructor reads (the batches come from the harness, not from it)."""
    data = {"images": [{"id": 1, "file_name": "unused.png", "height": h, "width": w}],
            "categories": [{"id": i + 1, "name": n} for i, n in enumerate(VOC)],
            "annotations": [{"id": i + 1, "image_id": 1, "category_id": i + 1,
                             "bbox": [8.0, 8.0, 64.0, 64.0], "area": 4096.0, "iscrowd": 0}
                            for i in range(len(VOC))]}
    path = os.path.join(workdir, "train.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def train_config(cfg: dict, tr: dict, ranks: int = 0):
    """The trainer's configuration; ``ranks`` > 0 puts it on the mesh's
    data axis over that many ranks."""
    from cl_object_detection_tpu_torch.config import (DataConfig, DistillConfig, ILConfig,
                                                       MeshConfig, ScheduleConfig, TrainConfig)
    from port_bench.common import model_config

    h, w = tr["frame"]
    return TrainConfig(
        model=model_config(cfg),
        data=DataConfig(batch_size=tr["batch"] * max(ranks, 1), height=h,
                        width=w, min_side=cfg["min_side"], max_side=cfg["max_side"],
                        fused_stem=True, transfer_dtype="uint8", num_workers=0),
        schedule=ScheduleConfig(lr=tr["lr"], grad_clip=tr["grad_clip"],
                                every_iter=tr["every_iter"]),
        il=ILConfig(scenario=tuple(tr["scenario"]), start_state=len(tr["scenario"]) - 1,
                    distill=DistillConfig(enabled=True)),
        mesh=MeshConfig(enabled=ranks > 0, num_model=1),
        start_epoch=2, async_checkpoint=False, record=False)


def seeded_weights(ctx, past: int, classes: int, first):
    """(teacher, student) on the host, made on the card from the seed;
    ``first`` holds the frames the calibration reads."""
    cfg, seed = ctx.config, ctx.seed
    with ctx.reference_precision():
        teacher = weights.make(cfg, past, inputs.sub_seed(seed, inputs.WEIGHTS), ctx.device)
        weights.calibrate(teacher, cfg, past, first)
        student = student_weights(teacher, cfg, past, classes, seed,
                                  ctx.traffic["student_spread"])
    return ({k: v.cpu() for k, v in teacher.items()}, {k: v.cpu() for k, v in student.items()})


def write_checkpoints(root: str, tcfg, teacher, student) -> None:
    """The teacher as the previous state's checkpoint and the student as
    this state's epoch 1, where the trainer of ``tcfg`` looks for them."""
    from cl_object_detection_tpu_torch.utils import checkpoint as ck

    mgr = ck.CheckpointManager(os.path.join(root, tcfg.checkpoint_dir), tcfg.il.scenario)
    state = tcfg.il.start_state
    for st, params in ((state - 1, teacher), (state, student)):
        path = mgr.epoch_dir(st, 1)
        os.makedirs(path)
        torch.save({"model": params, "optimizer": {}, "step": 0},
                   os.path.join(path, ck.STATE_FILE))


def batch_of(packed, boxes, labels, lo: int, n: int, boxes_per_image: int):
    """The trainer's ``Batch`` of frames ``lo .. lo + n`` of the ring."""
    from cl_object_detection_tpu_torch.data.loader import Batch

    s = slice(lo, lo + n)
    return Batch(images=packed[s], boxes=boxes[s], labels=labels[s],
                 num_boxes=np.full(n, boxes_per_image, np.int32),
                 num_pseudo=np.zeros(n, np.int32), scales=np.ones(n, np.float32),
                 image_ids=np.arange(lo, lo + n, dtype=np.int64))


# the program's loss terms (``run_batch``'s metrics) by the reference's names
TERMS = {"cls_fg_loss": "fg", "cls_bg_loss": "bg", "reg_loss": "box",
         "dist_feat_loss": "feat", "dist_reg_loss": "dist_box", "dist_cls_loss": "dist_cls"}


def first_steps(ctx, trainer, batch):
    """The first ``check_steps`` micro-steps, which the reference follows:
    (losses, each micro-step's loss terms by the reference's names, the
    first apply's gradient from Adam's ``mu``, the parameters after the
    last). A planted ``frozen`` fault makes the optimizer's step a no-op
    first."""
    tr = ctx.traffic
    if ctx.options.get("frozen"):
        trainer.optimizer.step = lambda *a, **k: None
    metrics, mu1 = [], None
    for i in range(tr["check_steps"]):
        metrics.append(trainer.run_batch(batch(i), sync_metrics=False))
        if mu1 is None and (i + 1) % tr["every_iter"] == 0:
            state = trainer.optimizer.state
            mu1 = {n: state[p]["mu"].clone() if p in state else torch.zeros_like(p)
                   for n, p in trainer.model.named_parameters()}
    after = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    one_minus_b1 = float(np.float32(1) - np.float32(0.9))
    losses = [float(m["total_loss"]) for m in metrics]
    terms = [{TERMS[k]: float(v) for k, v in m.items() if k in TERMS} for m in metrics]
    return losses, terms, {n: g / one_minus_b1 for n, g in mu1.items()}, after


def run(ctx) -> dict:
    from cl_object_detection_tpu_torch import _build
    from cl_object_detection_tpu_torch.train import trainer as port_trainer

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    b, ring, (h, w) = tr["batch"], tr["ring"], tr["frame"]
    counts = [int(s) for s in tr["scenario"]]
    classes, past = sum(counts), sum(counts[:-1])
    n = b // 2 if ctx.options.get("half_batch") else b
    if dev.type == "cuda":
        _build.build_all()
    rgb = inputs.frames(seed, ring * b, (h, w), tr["image"], dev)
    host_teacher, host_student = seeded_weights(ctx, past, classes, rgb[:2])
    boxes, labels = inputs.truth(seed, ring * b, tr["slots"], tr["boxes"], tr["box_side"],
                                 tr["image"], range(past, classes))
    packed = inputs.pack(rgb).cpu().numpy()
    del rgb
    ctx.fresh_memory()

    def batch(i: int):
        return batch_of(packed, boxes, labels, (i % ring) * b, n, tr["boxes"])

    workdir = tempfile.mkdtemp(prefix="port_bench_train_")
    try:
        tcfg = train_config(cfg, tr)
        write_checkpoints(workdir, tcfg, host_teacher, host_student)
        trainer = port_trainer.ILTrainer(tcfg, _dataset(workdir, h, w), workdir, workdir,
                                         device=dev)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    losses, terms, prog_grad, after = first_steps(ctx, trainer, batch)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    steps = 0
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        trainer.run_batch(batch(tr["check_steps"] + steps), sync_metrics=False)
        steps += 1
    ctx.sync()
    rec = record(ctx, setup_s, time.perf_counter() - start, steps, steps * n, classes, past)
    if ctx.trace and dev.type == "cuda":
        at = tr["check_steps"] + steps
        ctx.profile(rec, lambda i: trainer.run_batch(batch(at + i), sync_metrics=False),
                    tr["trace_steps"])
    rec["memory_peak_bytes"] = ctx.memory_peak()
    del trainer
    gc.collect()
    ctx.free()
    rec.update(check(ctx, host_teacher, host_student, packed.shape[0], boxes, labels, past,
                     classes, losses, terms, prog_grad, after))
    return rec


def record(ctx, setup_s, window_s, steps, items, classes, past) -> dict:
    """The run's record, which the metrics' readers read."""
    tr = ctx.traffic
    return {"kind": "train", "setup_s": setup_s, "window_s": window_s, "steps": steps,
            "items": items, "failed": 0,
            "work": {"config": ctx.config, "frame": tuple(tr["frame"]), "batch": tr["batch"],
                     "num_classes": classes, "num_past": past}}


def check(ctx, host_teacher, host_student, frames, boxes, labels, past, classes, losses,
          terms, prog_grad, after, batch: int = None, recompute: bool = False) -> dict:
    """The reference's steps on the first ``check_steps`` batches of
    ``batch`` frames (the traffic's batch by default), and the comparison
    with the program's ``losses`` and their ``terms``, first gradient and
    parameters ``after`` those steps."""
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    b, (h, w) = batch or tr["batch"], tr["frame"]
    start_params = {n: host_student[n].to(dev) for n in after}
    prog_change = {n: after[n] - start_params[n] for n in after}
    quant = ctx.options.get("reference_quant")
    with ctx.reference_precision():
        rgb = inputs.frames(seed, frames, (h, w), tr["image"], dev)
        bx, lb = torch.from_numpy(boxes).to(dev), torch.from_numpy(labels).to(dev).long()
        batches = [(rgb[i * b:(i + 1) * b], bx[i * b:(i + 1) * b], lb[i * b:(i + 1) * b])
                   for i in range(tr["check_steps"])]
        anc = torch.from_numpy(ref_detect.anchors(h, w)).to(dev)

        def steps(q):
            return ref_train.train({k: v.to(dev) for k, v in host_student.items()},
                                   {k: v.to(dev) for k, v in host_teacher.items()}, batches,
                                   anc, depth=cfg["depth"], num_classes=classes, num_past=past,
                                   micro_steps=tr["check_steps"], every_iter=tr["every_iter"],
                                   lr=tr["lr"], clip=tr["grad_clip"], quant=q,
                                   recompute=recompute)

        ref = steps(None)
        if quant is not None:        # the control: the reference in the program's place
            ctl = steps(quant)
            losses, terms, prog_grad = ctl["losses"], ctl["terms"], ctl["grad1"]
            prog_change = {n: ctl["params"][n] - start_params[n] for n in ctl["params"]}
    ref_change = {n: ref["params"][n] - start_params[n] for n in ref["params"]}
    numbers, details = compare.train_steps(losses, ref["losses"], prog_grad, ref["grad1"],
                                           prog_change, ref_change, terms, ref["terms"])
    return {"numbers": numbers, "details": details}


def variants(traffic: dict) -> dict:
    """Options of ``run`` for the control (the reference's steps at float8
    in the program's place, the nearest precision below bfloat16) and each
    planted fault."""
    return {"control": {"reference_quant": "fp8"}, "half_batch": {"half_batch": True},
            "frozen": {"frozen": True}}
