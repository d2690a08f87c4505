"""Deployment artifacts of the port (``eval/deploy.py``, ``cli/export.py``,
``cli/serve.py --from_export`` and ``--root_dir``), case for case as the
JAX package's ``tests/test_deploy.py``.

The contract: a checkpoint exported with ``torch.export`` loads back in a
fresh process without the model classes (``models`` never imported) and
gives detections bit-identical to the live predict path on the CPU, with
``--quantize`` and ``--bic`` baked in; the HTTP server serves the
artifact and a checkpoint the port's trainer wrote. Across packages: a
JAX model's variables bridged into the port give, through the port's
artifact, JAX's own artifact's detections (labels and valid equal, boxes
and scores at rtol 1e-4, the detection bar; float32, R18, FPN 32, one
head layer, 64x64 fused frames).
"""
import dataclasses
import http.client
import json
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch.config import ModelConfig, PredictConfig, TrainConfig
from cl_object_detection_tpu_torch.data.image_io import encode_png
from cl_object_detection_tpu_torch.eval.deploy import (
    ARTIFACT_META,
    artifact_blob,
    export_predict,
    load_artifact,
    load_serving_bundle,
    save_artifact,
)
from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
from cl_object_detection_tpu_torch.il.bic import bic_correct_from_meta
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"depth": 18, "fpn_channels": 32, "head_layers": 1, "compute_dtype": "float32"}
DATA = {"height": 64, "width": 64, "fused_stem": True}
FRAME = (16, 16, 64)
KEYS = ("boxes", "scores", "labels", "valid")
# std of the random head output convs: larger ones saturate the sigmoid,
# where float32 scores tie exactly and their order follows logits that
# the two frameworks round differently (at 0.01 two scores 1.3e-6 apart
# already come out swapped between JAX's artifact and the port's)
OUTPUT_STD = 0.005


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _frames(n, seed):
    x = np.random.RandomState(seed).randint(0, 256, (n,) + FRAME).astype(np.uint8)
    x[..., 48:] = 0                                    # the 4x4 layout's pad channels
    return x


def _write_run(root, scenario, state, num_classes, il_meta, seed=0, randomize=True):
    """A port run directory: a seeded model's checkpoint (random output
    convs unless ``randomize`` is off: then every logit ties) and the
    start state's params.json."""
    gen = torch.Generator().manual_seed(seed)
    model = create_retinanet(ModelConfig(**MODEL), num_classes, device="cpu", generator=gen)
    if randomize:
        with torch.no_grad():
            for head in (model.classification_head, model.regression_head):
                head.output.weight.copy_(torch.randn(head.output.weight.shape, generator=gen)
                                         * OUTPUT_STD)
    ckpt = CheckpointManager(os.path.join(root, "checkpoint"), scenario)
    ckpt.save(state, 1, model, torch.optim.SGD(model.parameters(), lr=0.1), 0,
              il_meta=il_meta)
    with open(os.path.join(ckpt.state_dir(state), "params.json"), "w") as f:
        json.dump({"model": MODEL, "data": DATA}, f)
    return model


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("deploy_run"))
    _write_run(root, ["3"], 0, 3, {"num_classes": 3})
    return root


@pytest.fixture(scope="module")
def artifact_dir(run_dir):
    from cl_object_detection_tpu_torch.cli.export import main

    out = os.path.join(run_dir, "artifact")
    main(["--root_dir", run_dir, "--scenario", "3", "--state", "0", "--batch", "2",
          "--score_thresh", "0.0", "--out", out, "--cpu"])
    return out


def _live(run_dir, scenario, state, images, **kw):
    bundle = load_serving_bundle(run_dir, scenario, state, device="cpu")
    bic = kw.pop("bic", False)
    correct = None
    if bic:
        counts = [2, 1]
        correct = bic_correct_from_meta(bundle.il_meta, counts, bundle.num_classes)
    det = make_predict_fn(bundle.model, PredictConfig(score_thresh=0.0, **kw),
                          bic_correct=correct)(torch.from_numpy(images))
    return {k: v.numpy() for k, v in zip(KEYS, det)}


def _assert_bit_identical(got, want):
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _op_counts(path):
    """How often each ``cldet`` operator is called in an exported program."""
    from collections import Counter

    from cl_object_detection_tpu_torch.ops import library  # noqa: F401

    program = torch.export.load(path)
    return Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                   if str(n.target).startswith("cldet."))


def test_artifact_files_and_meta(artifact_dir):
    assert os.path.exists(os.path.join(artifact_dir, artifact_blob("cpu")))
    assert not os.path.exists(os.path.join(artifact_dir, artifact_blob("cuda")))
    with open(os.path.join(artifact_dir, ARTIFACT_META)) as f:
        meta = json.load(f)
    assert meta["batch"] == 2
    assert meta["frame_shape"] == list(FRAME)
    assert meta["fused"] is True and meta["s2d"] is False
    assert meta["transfer_dtype"] == "uint8"
    assert meta["num_classes"] == 3
    assert meta["depth"] == 18
    assert meta["platforms"] == ["cpu"]
    assert meta["topk_method"] == "exact" and meta["quantize"] is False
    assert meta["bic"] is False
    # the kernels ride in the program as operators: the float32 stem and
    # the default NMS ("iterative"), once each
    assert _op_counts(os.path.join(artifact_dir, artifact_blob("cpu"))) == {
        "stem_fused_f32": 1, "nms_iterative": 1}


LOAD_PROBE = r"""
import json, sys
import numpy as np
from cl_object_detection_tpu_torch.eval.deploy import load_artifact
fn, meta = load_artifact(sys.argv[1], device="cpu")
out = fn(np.load(sys.argv[2]))
np.savez(sys.argv[3], **out)
print(json.dumps({"modules": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                          "cl_object_detection_tpu")
                                   or m.startswith("cl_object_detection_tpu_torch.models"))}))
"""


def _load_in_fresh_process(artifact, images, tmp_path):
    np.save(tmp_path / "x.npy", images)
    out = subprocess.run([sys.executable, "-c", LOAD_PROBE, artifact, str(tmp_path / "x.npy"),
                          str(tmp_path / "out.npz")],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["modules"] == []
    with np.load(tmp_path / "out.npz") as z:
        return {k: z[k] for k in KEYS}


def test_exported_matches_live_predict(run_dir, artifact_dir, tmp_path):
    """In a fresh process that imports ``eval.deploy`` alone: no JAX, no
    JAX package, no ``models``; the detections equal the live predict's
    bit for bit."""
    images = _frames(2, 0)
    got = _load_in_fresh_process(artifact_dir, images, tmp_path)
    _assert_bit_identical(got, _live(run_dir, ["3"], 0, images))
    assert got["valid"].sum() > 0


def test_export_composes_with_quantize(run_dir, tmp_path):
    """int8 dynamic PTQ bakes into the program: the int8 operators ride in
    it, and the loaded artifact equals the live quantized predict."""
    bundle = load_serving_bundle(run_dir, ["3"], 0, device="cpu")
    blobs, meta = export_predict(bundle, batch=1, score_thresh=0.0, quantize=True)
    assert meta["quantize"] is True
    out_dir = os.path.join(run_dir, "artifact_int8")
    save_artifact(out_dir, blobs, meta)
    ops = _op_counts(os.path.join(out_dir, artifact_blob("cpu")))
    # R18 with one head layer: 16 + 4 3x3 backbone/FPN convs + 2 x 5 head
    # trunks in conv mode; 3 downsamples + 3 laterals in GEMM mode (the
    # fused stem and the head outputs stay float)
    assert ops["int8_conv_nhwc"] > 0 and ops["int8_matmul"] > 0 and ops["stem_fused_f32"] == 1
    fn, _ = load_artifact(out_dir, device="cpu")
    images = _frames(1, 2)
    out = fn(images)
    assert out["valid"].sum() > 0
    assert np.isfinite(out["boxes"][out["valid"]]).all()
    _assert_bit_identical(out, _live(run_dir, ["3"], 0, images, quantize=True))


def test_export_topk_approx_equals_live(run_dir, tmp_path):
    """``--topk_method approx`` exports and equals the live ``approx``
    predict."""
    from cl_object_detection_tpu_torch.cli.export import main

    out_dir = os.path.join(run_dir, "artifact_approx")
    meta = main(["--root_dir", run_dir, "--scenario", "3", "--batch", "2", "--score_thresh",
                 "0.0", "--topk_method", "approx", "--out", out_dir, "--cpu"])
    assert meta["topk_method"] == "approx"
    fn, _ = load_artifact(out_dir, device="cpu")
    images = _frames(2, 3)
    _assert_bit_identical(fn(images), _live(run_dir, ["3"], 0, images, topk_method="approx"))


def test_bundle_arch_mismatch_fails_fast(run_dir):
    """A --depth override that contradicts the checkpoint raises a
    structural diff at load, not an error at first predict."""
    with pytest.raises(ValueError, match="does not match") as e:
        load_serving_bundle(run_dir, ["3"], 0, depth=50, device="cpu")
    assert "165 params missing from the checkpoint" in str(e.value)
    assert "of another shape (e.g. [('backbone.layer1_0.conv1.weight'" in str(e.value)


def test_export_bic_without_state_errors(run_dir):
    bundle = load_serving_bundle(run_dir, ["3"], 0, device="cpu")
    with pytest.raises(ValueError, match="BiC"):
        export_predict(bundle, batch=1, bic=True)


def test_export_for_an_absent_device_raises(run_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    bundle = load_serving_bundle(run_dir, ["3"], 0, device="cpu")
    with pytest.raises(RuntimeError, match="'cuda' needs a CUDA device"):
        export_predict(bundle, batch=1, platforms=["cuda"])
    with pytest.raises(ValueError, match="unknown platform"):
        export_predict(bundle, batch=1, platforms=["tpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_artifact(os.path.join(run_dir, "artifact"))


def test_export_bakes_bic_correction(tmp_path):
    """--bic on export: the artifact's detections differ from the
    uncorrected artifact's (the correction rides inside the program), and
    equal the live predict through ``bic_correct_from_meta``."""
    root = str(tmp_path)
    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, il=dataclasses.replace(cfg.il, scenario=("2", "1")))
    il_meta = {"num_classes": 3, "config": cfg.to_json(),
               # a strong correction so the prior-bias model's class-2
               # scores visibly move: 0.5*logit+2 lifts p from .01 to ~.43
               "bic": {"alphas": [0.5], "betas": [2.0]}}
    # the state-1 checkpoint of a fresh model (every logit at the prior);
    # params.json in state 0's directory, as the trainer leaves it
    _write_run(root, ["2", "1"], 1, 3, il_meta, randomize=False)
    os.makedirs(os.path.join(root, "checkpoint", "2_1", "state0"))
    os.rename(os.path.join(root, "checkpoint", "2_1", "state1", "params.json"),
              os.path.join(root, "checkpoint", "2_1", "state0", "params.json"))
    bundle = load_serving_bundle(root, ["2", "1"], 1, device="cpu")
    images = _frames(1, 3)
    outs = {}
    for use_bic in (False, True):
        blobs, meta = export_predict(bundle, batch=1, score_thresh=0.0, bic=use_bic)
        assert meta["bic"] is use_bic
        d = os.path.join(root, f"art_bic_{use_bic}")
        save_artifact(d, blobs, meta)
        fn, _ = load_artifact(d, device="cpu")
        outs[use_bic] = fn(images)
        _assert_bit_identical(outs[use_bic], _live(root, ["2", "1"], 1, images, bic=use_bic))
    bic_cls2 = outs[True]["scores"][outs[True]["labels"] == 2]
    assert bic_cls2.size and bic_cls2.max() > 0.2
    assert outs[False]["scores"].max() < 0.05
    assert not np.array_equal(outs[True]["scores"], outs[False]["scores"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_one_png(args, num_classes):
    """Start ``cli.serve --cpu`` with ``args``, wait for ``/healthz``, POST
    one PNG (decoded without OpenCV) and return its detections and the
    server's output."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cl_object_detection_tpu_torch.cli.serve", "--cpu",
         "--port", str(port), "--batch_window_ms", "5", "--score_thresh", "0.0", *args],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while True:
            assert proc.poll() is None, f"server died: {proc.stdout.read()[-3000:]}"
            try:
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
                c.request("GET", "/healthz")
                if c.getresponse().status == 200:
                    break
            except OSError:
                pass
            assert time.time() < deadline, "server never became healthy"
            time.sleep(0.5)
        img = np.random.RandomState(1).randint(0, 256, (48, 80, 3)).astype(np.uint8)
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("POST", "/detect", body=encode_png(img))
        r = c.getresponse()
        assert r.status == 200
        dets = json.loads(r.read())["detections"]
        for d in dets:
            assert 0 <= d["class_id"] < num_classes
            assert np.isfinite(d["box"]).all()
    finally:
        proc.kill()
        proc.wait(timeout=30)
    return dets, proc.stdout.read()


def test_serve_from_export_http(artifact_dir):
    dets, out = _serve_one_png(["--from_export", artifact_dir, "--max_batch", "4"], 3)
    assert len(dets) > 0
    assert "--max_batch 4 -> 2 (the artifact's static batch)" in out
    assert "artifact " + artifact_dir in out


def test_serve_root_dir_serves_a_trainer_checkpoint(tmp_path):
    """``cli.serve --root_dir`` reads a checkpoint tree the port's own
    trainer wrote (``cli.train``), through ``load_serving_bundle``."""
    from cl_object_detection_tpu_torch.cli.train import main as train_main
    from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

    json_path = make_toy_dataset(str(tmp_path / "toy"), num_images=4, image_size=(48, 64),
                                 seed=3)
    root = str(tmp_path / "run")
    train_main(["--root_dir", root, "--train_json", json_path, "--image_dir",
                str(tmp_path / "toy" / "images"), "--scenario", "5", "--end_epoch", "1",
                "--depth", "18", "--image_height", "128", "--image_width", "128",
                "--batch_size", "2", "--record", "false", "--print_il_info", "false",
                "--cpu"])
    dets, out = _serve_one_png(["--root_dir", root, "--scenario", "5", "--max_batch", "2",
                                "--nms_impl", "iterative"], 5)
    assert len(dets) > 0
    assert "depth 18, frame 128x128" in out


def test_jax_artifact_and_port_artifact_agree(tmp_path):
    """A JAX model's variables, bridged into the port and saved as a port
    run directory with JAX's params.json, export through the port; JAX's
    ``export_predict`` artifact of the same variables and the port's
    artifact run on the same seeded frames."""
    import jax
    import jax.numpy as jnp

    from cl_object_detection_tpu.config import ModelConfig as JModelConfig
    from cl_object_detection_tpu.eval import deploy as jdeploy
    from cl_object_detection_tpu.models import create_retinanet as j_create
    from cl_object_detection_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
    from cl_object_detection_tpu_torch.models.bridge import load_jax_variables

    params_json = {"model": MODEL, "data": DATA}
    jmodel = j_create(JModelConfig(**MODEL), 3)
    v = jax.tree.map(np.array, jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 3))))
    r = np.random.RandomState(9)
    for head in ("classification_head", "regression_head"):
        out = v["params"][head]["output"]
        out["kernel"] = (r.randn(*out["kernel"].shape) * OUTPUT_STD).astype(np.float32)

    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt = JCheckpointManager(os.path.join(jroot, "checkpoint"), ["3"])
    jckpt.save(0, 1, SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"],
                                     opt_state={"none": np.zeros(1)}, step=0),
               il_meta={"num_classes": 3})
    with open(os.path.join(jckpt.state_dir(0), "params.json"), "w") as f:
        json.dump(params_json, f)
    tmodel = create_retinanet(ModelConfig(**MODEL), 3, device="cpu")
    load_jax_variables(tmodel, v)
    tckpt = CheckpointManager(os.path.join(troot, "checkpoint"), ["3"])
    tckpt.save(0, 1, tmodel, torch.optim.SGD(tmodel.parameters(), lr=0.1), 0,
               il_meta={"num_classes": 3})
    with open(os.path.join(tckpt.state_dir(0), "params.json"), "w") as f:
        json.dump(params_json, f)

    blob, jmeta = jdeploy.export_predict(jdeploy.load_serving_bundle(jroot, ["3"], 0), batch=2)
    jdeploy.save_artifact(str(tmp_path / "jart"), blob, jmeta)
    jfn, _ = jdeploy.load_artifact(str(tmp_path / "jart"))
    blobs, tmeta = export_predict(load_serving_bundle(troot, ["3"], 0, device="cpu"), batch=2)
    save_artifact(str(tmp_path / "tart"), blobs, tmeta)
    tfn, _ = load_artifact(str(tmp_path / "tart"), device="cpu")
    assert {k: v for k, v in tmeta.items() if k != "platforms"} == {
        k: v for k, v in jmeta.items() if k != "platforms"}

    images = _frames(2, 6)
    want, got = jfn(images), tfn(images)
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-3)
