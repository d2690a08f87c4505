"""Closed-loop predict: one batch in flight through the serving entry.

The timed call is ``cli.serve.make_run_predict(make_predict_fn(model,
PredictConfig(...)), device)`` of the port, numpy frames in and numpy
detections out, which is what the server's device loop calls for each
micro-batch. The traffic's parameters (``traffic/<name>.json``):
``batch``, ``frame`` (the padded frame), ``image`` (the picture inside
it), ``ring`` (distinct seeded host batches, sent in turn), the
post-processing (``nms_impl``, ``topk_method``), ``quantize`` (the int8
path), ``trace_batches`` (batches under the profiler after the window)
and ``check_batches`` (window batches drawn from the seed for the check).

Set-up: the kernels built or loaded, the weights made on the card and
calibrated, the model, and one call per ring batch (every shape the
window meets). The window sends batches until ``--seconds`` have passed.
With ``--trace 1`` CUDA events at the forward's boundary (module hooks)
and at the end of the predict time each batch, and ``trace_batches``
more batches run under the profiler. The check then compares the
sampled batches' detections with the reference's.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench import compare, inputs, weights
from port_bench.common import build_model
from port_bench.reference import detect as ref_detect
from port_bench.reference.retinanet import Net


def reference_predict(cfg: dict, tr: dict, params, rgb: torch.Tensor, quant) -> dict:
    """The reference's detections of ``rgb`` (uint8 RGB on the device)."""
    h, w = tr["frame"]
    net = Net(params, cfg["depth"], cfg["num_classes"], tuple(cfg["input_mean"]),
              tuple(cfg["input_std"]), cfg["head_layers"], cfg["num_anchors"], quant)
    logits, deltas, _ = net.forward_all(rgb)
    anc = torch.from_numpy(ref_detect.anchors(h, w)).to(rgb.device)
    return ref_detect.detect(logits, deltas, anc, h, w, cfg["score_thresh"], cfg["nms_iou"],
                             cfg["pre_nms_topk"], cfg["max_detections"], tuple(cfg["bbox_std"]))


def run(ctx) -> dict:
    from cl_object_detection_tpu_torch import _build
    from cl_object_detection_tpu_torch.cli import serve
    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.eval import predictor

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    b, ring, (h, w) = tr["batch"], tr["ring"], tr["frame"]
    c = cfg["num_classes"]
    if dev.type == "cuda":
        _build.build_all()
    with ctx.reference_precision():
        params = weights.make(cfg, c, inputs.sub_seed(seed, inputs.WEIGHTS), dev)
        rgb = inputs.frames(seed, ring * b, (h, w), tr["image"], dev)
        weights.calibrate(params, cfg, c, rgb[:2])
    host_params = {k: v.cpu() for k, v in params.items()}
    frames = [inputs.pack(rgb[i * b:(i + 1) * b]).cpu().numpy() for i in range(ring)]
    del rgb
    model = build_model(cfg, c, params, dev)
    del params
    ctx.fresh_memory()

    pcfg = PredictConfig(score_thresh=cfg["score_thresh"], nms_iou=cfg["nms_iou"],
                         pre_nms_topk=cfg["pre_nms_topk"],
                         max_detections=cfg["max_detections"], nms_impl=tr["nms_impl"],
                         topk_method=tr["topk_method"], bbox_std=tuple(cfg["bbox_std"]),
                         quantize=bool(ctx.options.get("quantize", tr.get("quantize", False))))
    predict = predictor.make_predict_fn(model, pcfg)
    timing = ctx.trace and dev.type == "cuda"
    marks: list = []
    if timing:
        def mark(*_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)

        hooks = [model.register_forward_pre_hook(mark), model.register_forward_hook(mark)]

        def predict_marked(images, _predict=predict):
            det = _predict(images)
            mark()
            return det

        run_predict = serve.make_run_predict(predict_marked, dev)
    else:
        run_predict = serve.make_run_predict(predict, dev)
    if "timed" in ctx.options:          # a control or a planted fault in its place
        run_predict = ctx.options["timed"](run_predict, ctx, host_params)

    for f in frames:                    # warm-up: every batch of the ring once
        run_predict(f)
    ctx.sync()
    marks.clear()
    setup_s = time.perf_counter() - ctx.t0

    outputs, host_s = [], []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        outputs.append(run_predict(frames[len(outputs) % ring]))
        t1 = time.perf_counter()
        host_s.append(t1 - t0)
        if t1 - start >= ctx.seconds:
            break
    window_s = time.perf_counter() - start
    n = len(outputs)

    rec = {"kind": "predict", "setup_s": setup_s, "window_s": window_s, "items": n * b, "batches": n,
           "latencies_s": host_s, "batch": b, "failed": 0}
    if timing:
        ctx.sync()
        fwd = [marks[3 * i].elapsed_time(marks[3 * i + 1]) for i in range(n)]
        post = [marks[3 * i + 1].elapsed_time(marks[3 * i + 2]) for i in range(n)]
        rec["events_ms"] = {"forward": fwd, "postprocess": post}
        for hk in hooks:
            hk.remove()
        ctx.profile(rec, lambda i: run_predict(frames[i % ring]), tr["trace_batches"])
    rec["memory_peak_bytes"] = ctx.memory_peak()
    del model, predict, run_predict
    gc.collect()
    ctx.free()

    # the check: sampled window batches against the reference
    r = np.random.default_rng(inputs.sub_seed(seed, inputs.SAMPLE))
    picked = sorted(r.choice(n, size=min(n, tr["check_batches"]), replace=False).tolist())
    slots = sorted({i % ring for i in picked})
    tally = compare.DetectionTally()
    with ctx.reference_precision(), torch.no_grad():
        params = {k: v.to(dev) for k, v in host_params.items()}
        rgb = inputs.frames(seed, ring * b, (h, w), tr["image"], dev)
        for s in slots:
            # the int8 traffic's reference computes the int8 semantics
            ref = reference_predict(cfg, tr, params, rgb[s * b:(s + 1) * b],
                                    127 if tr.get("quantize") else None)
            for i in picked:
                if i % ring == s:
                    tally.add(outputs[i], ref)
    rec["numbers"] = tally.numbers()
    rec["checked_batches"] = len(picked)
    rec["work"] = {"config": cfg, "frame": (h, w), "batch": b,
                   "int8": bool(pcfg.quantize)}
    return rec


# ---- what the control and the planted faults put in the timed call's place

def _reference_in_place(levels):
    """The reference, quantized to ``levels``, as the timed call."""
    def wrap(run_predict, ctx, host_params):
        params = {k: v.to(ctx.device) for k, v in host_params.items()}

        def timed(frames):
            with ctx.reference_precision(), torch.no_grad():
                rgb = inputs.unpack(torch.from_numpy(frames).to(ctx.device))
                det = reference_predict(ctx.config, ctx.traffic, params, rgb, levels)
                return {k: v.cpu().numpy() for k, v in det.items()}
        return timed
    return wrap


def _half_batch(run_predict, ctx, host_params):
    """Only the first half of each batch predicted; its detections stand
    in for the rest."""
    def timed(frames):
        half = frames.shape[0] // 2
        out = run_predict(np.ascontiguousarray(frames[:half]))
        return {k: np.concatenate([v, v[:frames.shape[0] - half]]) for k, v in out.items()}
    return timed


def _altered(run_predict, ctx, host_params):
    """The first image's answer altered where it is produced: every label
    moved to the next class."""
    classes = ctx.config["num_classes"]

    def timed(frames):
        out = dict(run_predict(frames))
        labels = out["labels"].copy()
        labels[0] = (labels[0] + 1) % classes
        out["labels"] = labels
        return out
    return timed


def variants(traffic: dict) -> dict:
    """Options of ``run`` for the control and each planted fault. The
    control is the nearest precision below the traffic's: the program's
    own int8 path for bfloat16, the reference at int4 for int8."""
    control = ({"timed": _reference_in_place(7)} if traffic.get("quantize")
               else {"quantize": True})
    return {"control": control, "half_batch": {"timed": _half_batch},
            "altered": {"timed": _altered}}
