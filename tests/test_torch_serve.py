"""The port's serve CLI end to end on the CPU: a tiny R18 run's weights
as a flat npz plus its params.json, ``cli.serve --cpu`` (float and
``--quantize``) in a subprocess, ``GET /healthz`` and ``POST /detect``
over HTTP; flags a route does not take and a missing GPU are refused."""
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch import resolve_device
from cl_object_detection_tpu_torch.config import ModelConfig
from cl_object_detection_tpu_torch.models.bridge import save_npz
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

from test_torch_model import CFG, H, W, jax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_cmd(*args):
    return [sys.executable, "-m", "cl_object_detection_tpu_torch.cli.serve", *args]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("run")
    _, v = jax_variables(seed=2)
    save_npz(str(d / "w.npz"), v)
    model_cfg = {k: v for k, v in CFG.items() if k != "compute_dtype"}
    with open(d / "params.json", "w") as f:
        json.dump({"model": model_cfg,
                   "data": {"height": H, "width": W, "fused_stem": True}}, f)
    return d


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_and_detect(run_dir, *extra):
    """Start ``cli.serve --cpu`` on the run, wait for ``/healthz``, POST one
    PNG to ``/detect``, check the detections; returns the server's output."""
    cv2 = pytest.importorskip("cv2")
    img = (np.random.RandomState(4).rand(50, 70, 3) * 255).astype(np.uint8)
    ok, png = cv2.imencode(".png", img)
    assert ok
    port = _free_port()
    proc = subprocess.Popen(
        _serve_cmd("--weights", str(run_dir / "w.npz"),
                   "--params_json", str(run_dir / "params.json"), "--cpu",
                   "--port", str(port), "--max_batch", "2",
                   "--score_thresh", "0.01", *extra),
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    assert r.read() == b"ok"
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.5)
        req = urllib.request.Request(url + "/detect", data=png.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        dets = body["detections"]
        assert dets, body
        for d in dets:
            assert len(d["box"]) == 4 and np.isfinite(d["box"]).all()
            assert 0.01 < d["score"] <= 1.0
            assert 0 <= d["class_id"] < 3
    finally:
        proc.kill()
        proc.wait(timeout=30)
    return proc.stdout.read()


def test_serve_answers_http_requests(run_dir):
    assert "float convs" in _serve_and_detect(run_dir)


def test_serve_quantize_answers_http_requests(run_dir):
    """``--quantize`` serves: the int8 convs run (the plain int8 GEMM on
    the CPU) and the server answers ``/detect``."""
    assert "int8 convs" in _serve_and_detect(run_dir, "--quantize")


@pytest.mark.parametrize("flags,message", [
    (["--weights", "w.npz", "--from_export", "art"], "excludes"),
    (["--weights", "w.npz", "--root_dir", "run"], "excludes"),
    (["--params_json", "params.json"], "applies to --weights only"),
    (["--root_dir", "run", "--height", "64"], "applies to --weights only"),
])
def test_serve_refuses_unported_options(run_dir, flags, message):
    """Options a route does not take are refused before anything loads:
    ``--weights`` (the bridge route) excludes ``--root_dir`` and
    ``--from_export``, and the bridge route's frame flags apply to it
    alone."""
    out = subprocess.run(_serve_cmd(*flags), cwd=run_dir, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2
    assert message in out.stderr


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_retinanet(ModelConfig(**CFG), 3)
    assert resolve_device("cpu").type == "cpu"
