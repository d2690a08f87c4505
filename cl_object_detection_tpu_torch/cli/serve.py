"""Batched detection HTTP server (the JAX package's ``cli/serve.py``).

A stdlib HTTP server whose handler threads decode and letterbox images
and queue them; one device thread micro-batches the queue into the
predict path (``device_loop``), padding every batch to ``--max_batch``.

    python -m cl_object_detection_tpu_torch.cli.serve --root_dir run \
        --scenario 20 --state 0 [--epoch -1] [--nms_impl pallas_fp] \
        [--quantize] [--port 8500] [--cpu]
    python -m cl_object_detection_tpu_torch.cli.serve --from_export art/
        # a cli.export artifact: no checkpoint tree, no model code
    python -m cl_object_detection_tpu_torch.cli.serve --weights w.npz \
        [--params_json run/params.json] [--depth 50] [--height 608 \
        --width 832] [--fused_stem] ...

Three routes. ``--root_dir`` (the default, ``.``) serves a checkpoint
the port's trainer wrote, rebuilt by ``eval.deploy.load_serving_bundle``
from the run's ``params.json`` (frame, depth, stem form). ``--from_export``
serves an artifact of ``cli.export`` through ``eval.deploy.load_artifact``,
taking batch, frame, layout and dtype from its ``meta.json``.
``--weights`` serves a flat ``"/"``-keyed ``.npz`` of the JAX variable
tree (``models/bridge.py``); frame, depth, stem form and dtype come from
the flags, else from ``--params_json``, else the config defaults, and
the class count from the weights. ``--quantize`` runs the int8 convs of
``ops/quant.py`` (an artifact carries its own).

Request bodies are decoded by ``data/image_io.decode_image``: PNG
without any image library, JPEG and the rest through OpenCV or PIL when
one is installed.

API:
  POST /detect      body: raw PNG/JPEG bytes
                    -> {"detections": [{"box": [x1,y1,x2,y2],
                        "score": s, "class_id": c}, ...]}
  GET  /healthz     -> ok
"""
from __future__ import annotations

import argparse
import json
import queue
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

import numpy as np


def submit(work: "queue.Queue", frame: np.ndarray, scale: float,
           timeout: float) -> Optional[dict]:
    """Queue one letterboxed frame for ``device_loop`` and wait for its
    answer: ``{"detections": [...]}``, ``{"error": ...}``, or None when
    ``timeout`` seconds pass first."""
    done = threading.Event()
    out: dict = {}
    work.put(((frame, scale), done, out, time.time()))
    return out if done.wait(timeout=timeout) else None


def device_loop(work: "queue.Queue", run_predict: Callable[[np.ndarray], Dict[str, np.ndarray]],
                frame_shape: Tuple[int, ...], frame_dtype, *, max_batch: int,
                batch_window_ms: float, request_ttl: float,
                score_thresh: float, stop: Optional[threading.Event] = None) -> None:
    """The device thread: take the first queued request, gather more for
    up to ``batch_window_ms`` (at most ``max_batch``), drop the ones older
    than ``request_ttl``, pad to ``max_batch`` and answer each request
    with its detections above ``score_thresh`` (boxes in the original
    image's pixels). A failing batch fails its requests and the loop goes
    on. Returns when ``stop`` is set."""
    while stop is None or not stop.is_set():
        try:
            first = work.get(timeout=0.1)
        except queue.Empty:
            continue
        batch = [first]
        deadline = time.perf_counter() + batch_window_ms / 1e3
        while len(batch) < max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                batch.append(work.get(timeout=timeout))
            except queue.Empty:
                break
        now = time.time()
        live = []
        for item in batch:
            if now - item[3] > request_ttl:
                item[2].setdefault("error", "expired in queue")
                item[1].set()
            else:
                live.append(item)
        batch = live
        if not batch:
            continue
        try:
            images = np.zeros((max_batch,) + tuple(frame_shape), frame_dtype)
            scales = np.ones(max_batch, np.float32)
            for i, (img, _done, _out, _t) in enumerate(batch):
                images[i], scales[i] = img
            det = run_predict(images)
            boxes, scores = det["boxes"], det["scores"]
            labels, valid = det["labels"], det["valid"]
            for i, (_img, done, out, _t) in enumerate(batch):
                keep = valid[i] & (scores[i] > score_thresh)
                out["detections"] = [
                    {"box": (boxes[i, d] / scales[i]).tolist(),
                     "score": float(scores[i, d]),
                     "class_id": int(labels[i, d])}
                    for d in np.where(keep)[0]
                ]
                done.set()
        except Exception as e:  # keep serving; fail the affected requests
            for _img, done, out, _t in batch:
                if done.is_set():
                    continue
                out.setdefault("error", f"{type(e).__name__}: {e}")
                done.set()


def frame_spec(height: int, width: int, s2d: bool, fused: bool,
               uint8: bool) -> Tuple[Tuple[int, ...], type]:
    """The (shape, dtype) of one served frame."""
    shape = ((height // 2, width // 2, 12) if s2d
             else (height // 4, width // 4, 64) if fused
             else (height, width, 3))
    return shape, (np.uint8 if uint8 else np.float32)


def make_run_predict(predict, device) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    """Wrap a port ``predict`` as numpy frames in -> numpy detections out."""
    import torch

    def run_predict(images: np.ndarray) -> Dict[str, np.ndarray]:
        det = predict(torch.from_numpy(images).to(device))
        return {"boxes": det.boxes.cpu().numpy(),
                "scores": det.scores.cpu().numpy(),
                "labels": det.labels.cpu().numpy(),
                "valid": det.valid.cpu().numpy()}

    return run_predict


def _bridged_model(a, device):
    """The ``--weights`` route: a model from a JAX variable tree; returns
    (model, depth, height, width, s2d, fused)."""
    from ..config import DataConfig
    from ..eval.deploy import model_config_from_run
    from ..models.bridge import load_jax_variables, load_npz
    from ..models.retinanet import create_retinanet

    run_cfg: dict = {}
    if a.params_json:
        with open(a.params_json) as f:
            run_cfg = json.load(f)
    mcfg = model_config_from_run(run_cfg, a.depth)
    run_data = run_cfg.get("data", {})
    height = a.height or int(run_data.get("height", DataConfig.height))
    width = a.width or int(run_data.get("width", DataConfig.width))
    s2d = bool(run_data.get("s2d_stem", False))
    fused = (a.fused_stem if a.fused_stem is not None
             else bool(run_data.get("fused_stem", False))) and not s2d
    tree = load_npz(a.weights)
    num_classes = a.num_classes or (
        tree["params"]["classification_head"]["output"]["bias"].shape[0]
        // mcfg.num_anchors)
    model = create_retinanet(mcfg, num_classes, device=device)
    load_jax_variables(model, tree)
    return model, mcfg.depth, height, width, s2d, fused


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root_dir", default=None,
                        help="a run directory of the port's trainer (its "
                             "checkpoint tree and params.json); default '.' "
                             "unless --weights or --from_export is given")
    parser.add_argument("--scenario", nargs="+", default=["20"])
    parser.add_argument("--state", type=int, default=0)
    parser.add_argument("--epoch", type=int, default=-1)
    parser.add_argument("--depth", type=int, default=None,
                        help="backbone depth; default: read from the "
                             "training run's params.json (else 50)")
    parser.add_argument("--weights", default=None,
                        help="instead of --root_dir: a flat '/'-keyed .npz "
                             "of the JAX variable tree (models/bridge.py)")
    parser.add_argument("--params_json", default=None,
                        help="with --weights: a training run's params.json "
                             "(model/data sections)")
    parser.add_argument("--height", type=int, default=None, help="with --weights")
    parser.add_argument("--width", type=int, default=None, help="with --weights")
    parser.add_argument("--num_classes", type=int, default=None,
                        help="with --weights; default: from the classifier's "
                             "output bias")
    parser.add_argument("--fused_stem", action="store_true", default=None,
                        help="with --weights: serve 4x4 space-to-depth frames "
                             "through the fused stem kernel")
    parser.add_argument("--nms_impl", default="pallas_fp",
                        choices=["pallas_fp", "iterative", "scan"])
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--batch_window_ms", type=float, default=5.0)
    parser.add_argument("--score_thresh", type=float, default=0.3)
    parser.add_argument("--request_ttl", type=float, default=60.0)
    parser.add_argument("--transfer_dtype", default="uint8",
                        choices=["float32", "uint8"])
    parser.add_argument("--quantize", action="store_true",
                        help="int8 dynamic-PTQ convs (ops/quant.py)")
    parser.add_argument("--from_export", default=None,
                        help="serve a cli.export artifact directory (the "
                             "exported program of eval/deploy.py; ignores "
                             "--root_dir/--scenario/--state/--epoch/--depth/"
                             "--quantize/--nms_impl and takes batch/frame/"
                             "dtype from the artifact's meta.json)")
    parser.add_argument("--cpu", action="store_true")
    a = parser.parse_args(argv)
    if a.weights and (a.root_dir or a.from_export):
        parser.error("--weights serves a bridged .npz: it excludes --root_dir and "
                     "--from_export")
    bridge_only = [f for f in ("params_json", "height", "width", "num_classes", "fused_stem")
                   if getattr(a, f) is not None]
    if bridge_only and not a.weights:
        parser.error(f"--{bridge_only[0]} applies to --weights only")

    from .. import resolve_device
    from ..config import PredictConfig
    from ..data.image_io import decode_image
    from ..data.transforms import normalize_image, resize_bilinear, space_to_depth
    from ..eval.predictor import make_predict_fn

    device = resolve_device("cpu" if a.cpu else None)
    if a.from_export:
        # the artifact path: no checkpoint tree, no model classes; the
        # weights, architecture, post-process and frame contract ride in
        # the exported program and meta.json (eval/deploy.py)
        from ..eval.deploy import load_artifact

        if a.quantize:
            print("note: --quantize is ignored with --from_export "
                  "(quantization bakes in at cli.export time)")
        run_predict, meta = load_artifact(a.from_export, device)
        depth, height, width = meta["depth"], meta["height"], meta["width"]
        s2d, fused = bool(meta["s2d"]), bool(meta["fused"])
        uint8 = meta["transfer_dtype"] == "uint8"
        quantize = bool(meta["quantize"])
        if a.transfer_dtype != meta["transfer_dtype"]:
            print(f"note: artifact input dtype is "
                  f"{meta['transfer_dtype']} (--transfer_dtype ignored)")
        if a.max_batch != meta["batch"]:
            print(f"--max_batch {a.max_batch} -> {meta['batch']} "
                  f"(the artifact's static batch)")
            a.max_batch = meta["batch"]
        if a.score_thresh < meta["score_thresh"]:
            print(f"warning: --score_thresh {a.score_thresh} below the "
                  f"artifact's baked {meta['score_thresh']} floor")
    else:
        if a.weights:
            model, depth, height, width, s2d, fused = _bridged_model(a, device)
        else:
            from ..eval.deploy import load_serving_bundle

            bundle = load_serving_bundle(a.root_dir or ".", a.scenario, a.state, a.epoch,
                                         a.depth, device)
            model, depth = bundle.model, bundle.mcfg.depth
            height, width, s2d, fused = bundle.height, bundle.width, bundle.s2d, bundle.fused
        uint8 = a.transfer_dtype == "uint8"
        quantize = a.quantize
        # the predict path keeps every candidate the server might emit
        predict = make_predict_fn(model, PredictConfig(
            score_thresh=min(0.05, a.score_thresh), nms_impl=a.nms_impl,
            quantize=a.quantize))
        run_predict = make_run_predict(predict, device)
    frame_shape, frame_dtype = frame_spec(height, width, s2d, fused, uint8)

    def letterbox(img):
        """Fit any orientation into the landscape serving frame (scale =
        min(H/h, W/w), zero pad), in the handler thread."""
        h, w = img.shape[:2]
        scale = min(height / h, width / w)
        nh, nw = int(h * scale), int(w * scale)
        resized = resize_bilinear(img, nh, nw)
        out = np.zeros((height, width, 3), np.uint8 if uint8 else np.float32)
        if uint8:
            out[:nh, :nw] = np.clip(np.round(resized * 255.0), 0, 255)
        else:
            out[:nh, :nw] = resized
            out = normalize_image(out)
        if s2d or fused:
            out = space_to_depth(out[None], factor=4 if fused else 2)[0]
        return out, scale

    work: "queue.Queue" = queue.Queue()
    threading.Thread(
        target=device_loop, daemon=True,
        args=(work, run_predict, frame_shape, frame_dtype),
        kwargs=dict(max_batch=a.max_batch, batch_window_ms=a.batch_window_ms,
                    request_ttl=a.request_ttl, score_thresh=a.score_thresh),
    ).start()
    # warm up through the device thread itself (cuDNN keeps its plans per
    # thread, so a warm-up elsewhere would leave the first request to pay
    # for them), and fail on a model/frame mismatch before taking traffic
    warm = submit(work, np.zeros(frame_shape, frame_dtype), 1.0, a.request_ttl)
    if warm is None or "error" in warm:
        raise SystemExit(f"warm-up predict failed: {warm}")
    print(f"serving on :{a.port} (batch {a.max_batch}, depth {depth}, "
          f"frame {height}x{width}, {'int8' if quantize else 'float'} convs, "
          f"{device}{', artifact ' + a.from_export if a.from_export else ''})", flush=True)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"ok")
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path != "/detect":
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                rgb = decode_image(self.rfile.read(length), name="request body")
            except (ValueError, ImportError, zlib.error, struct.error) as e:
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps({"error": f"undecodable image: {e}"}).encode())
                return
            frame, scale = letterbox(rgb.astype(np.float32) / 255)
            out = submit(work, frame, scale, a.request_ttl)
            if out is None:
                self.send_response(503)
                self.end_headers()
                self.wfile.write(b'{"error": "inference timeout"}')
                return
            body = json.dumps(out).encode()
            self.send_response(500 if "error" in out else 200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

    ThreadingHTTPServer(("0.0.0.0", a.port), Handler).serve_forever()


if __name__ == "__main__":
    main()
