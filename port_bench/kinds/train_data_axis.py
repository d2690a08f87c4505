"""Incremental-state micro-steps on the mesh's data axis: one process per
card, each a rank of ``torch.distributed`` (NCCL on cards, gloo on CPUs),
each driving its own ``ILTrainer.run_batch(batch, sync_metrics=False)``.

The traffic is ``train_state1``'s (``kinds/train_state1.py``) plus
``ranks``: ``batch`` frames a rank, so the global batch is ``ranks x
batch``, each global batch split into the ranks' slices in rank order,
as the trainer's loader gives them. The run's process is rank 0; it
starts the other ranks as processes of ``run.py`` (``--rank``), which
rendezvous with it through a file store and take the cell from a file,
both in a directory that rank 0 makes under ``TMPDIR`` (no port is picked,
so no other process can take it first). Rank 0 writes the two
checkpoints there too, and every rank's trainer reads them (the
student's whole parameters are then broadcast from rank 0, as the
trainer does). A gloo group beside the mesh carries rank 0's decision
to go on with the window from one micro-step to the next, on the host
alone, so every rank runs the same micro-steps. The window, the trace and the kept state are rank 0's;
``memory_peak_bytes`` is the fullest card's.

The check runs one process's reference over the whole global batch
(its blocks recompute their activations in the backward, so 64 frames
fit on one card) and compares rank 0's losses, moments and parameters.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import torch

from port_bench import inputs, registry

base = registry.kind("train_state1")
RUN = str(registry.HERE / "run.py")


def run(ctx) -> dict:
    world = int(ctx.traffic["ranks"])
    share = tempfile.mkdtemp(prefix="port_bench_mesh_")
    url = "file://" + os.path.join(share, "store")
    spec = os.path.join(share, "cell.json")
    with open(spec, "w") as f:
        json.dump({"name": ctx.cell.name, "config": ctx.config, "traffic": ctx.traffic}, f)
    procs = []
    try:
        for r in range(1, world):
            log = open(os.path.join(share, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, RUN, "--workload", ctx.cell.name, "--seed", str(ctx.seed),
                 "--seconds", str(ctx.seconds), "--trace", str(int(ctx.trace)), "--rank", str(r),
                 "--world", str(world), "--rendezvous", url, "--share", share,
                 "--options", json.dumps(ctx.options), "--device", ctx.device.type],
                stdout=log, stderr=subprocess.STDOUT), log))
        rec = run_rank(ctx, 0, world, url, share)
        for p, log in procs:
            if p.wait(timeout=600) != 0:
                log.close()
                with open(log.name) as f:
                    raise RuntimeError(f"rank process failed ({p.returncode}):\n"
                                       + f.read()[-4000:])
        return rec
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(share, ignore_errors=True)


def run_rank(ctx, rank: int, world: int, url: str, share: str):
    import torch.distributed as dist

    from cl_object_detection_tpu_torch import _build
    from cl_object_detection_tpu_torch.train import step as port_step
    from cl_object_detection_tpu_torch.train import trainer as port_trainer

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    b, ring, (h, w) = tr["batch"], tr["ring"], tr["frame"]
    glob = b * world
    counts = [int(s) for s in tr["scenario"]]
    classes, past = sum(counts), sum(counts[:-1])
    n = b // 2 if ctx.options.get("half_batch") else b
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _build.build_all()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=url,
                            rank=rank, world_size=world, timeout=timedelta(minutes=10))
    try:
        host = dist.new_group(backend="gloo")
        tcfg = base.train_config(cfg, tr, ranks=world)
        rgb = inputs.frames(seed, ring * glob, (h, w), tr["image"], dev)
        if rank == 0:
            host_teacher, host_student = base.seeded_weights(ctx, past, classes, rgb[:2])
            base.write_checkpoints(share, tcfg, host_teacher, host_student)
            base._dataset(share, h, w)
        boxes, labels = inputs.truth(seed, ring * glob, tr["slots"], tr["boxes"],
                                     tr["box_side"], tr["image"], range(past, classes))
        packed = inputs.pack(rgb).cpu().numpy()
        del rgb
        ctx.fresh_memory()
        dist.barrier(group=host)

        def batch(i: int):
            return base.batch_of(packed, boxes, labels, (i % ring) * glob + rank * b, n,
                                 tr["boxes"])

        trainer = port_trainer.ILTrainer(tcfg, os.path.join(share, "train.json"), share,
                                         share, device=dev)
        if ctx.options.get("no_exchange"):      # a planted fault: no gradient all-reduce
            port_step.all_reduce_grads = lambda mesh, g: g
        losses, terms, prog_grad, after = base.first_steps(ctx, trainer, batch)
        ctx.sync()
        dist.barrier(group=host)
        setup_s = time.perf_counter() - ctx.t0

        go = torch.zeros(1, dtype=torch.int32)
        steps = 0
        start = time.perf_counter()
        while True:
            if rank == 0:
                go[0] = int(time.perf_counter() - start < ctx.seconds)
            dist.broadcast(go, 0, group=host)
            if not int(go[0]):
                break
            trainer.run_batch(batch(tr["check_steps"] + steps), sync_metrics=False)
            steps += 1
        ctx.sync()
        rec = base.record(ctx, setup_s, time.perf_counter() - start, steps, steps * n * world,
                          classes, past)
        if ctx.trace and dev.type == "cuda":
            at = tr["check_steps"] + steps
            step = lambda i: trainer.run_batch(batch(at + i), sync_metrics=False)
            if rank == 0:
                ctx.profile(rec, step, tr["trace_steps"])
            else:                               # the same micro-steps as rank 0's two passes
                for i in range(2 * tr["trace_steps"]):
                    step(i)
                ctx.sync()
        peak = torch.tensor([ctx.memory_peak()], dtype=torch.int64)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=host)
        rec["memory_peak_bytes"] = int(peak[0])
        del trainer
        gc.collect()
        ctx.free()
        dist.barrier(group=host)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None
    rec.update(base.check(ctx, host_teacher, host_student, packed.shape[0], boxes, labels,
                          past, classes, losses, terms, prog_grad, after, batch=glob,
                          recompute=True))
    return rec


def variants(traffic: dict) -> dict:
    """The control and the planted faults: ``train_state1``'s, and the
    gradient exchange between the ranks left out."""
    return dict(base.variants(traffic), no_exchange={"no_exchange": True})
