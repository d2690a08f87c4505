"""The port's evaluation CLIs (``cli/validate.py``, ``cli/detect.py``,
``cli.train --val true``) on the CPU, against the JAX package's.

Both packages' CLIs build the model from ``ModelConfig(depth=...)``; the
tests narrow it to the small float32 R18 of tests/test_torch_eval.py
(FPN 32, 2 head layers) by patching ``ModelConfig`` where each CLI looks
it up, so that the two compute in float32 at the predict bar. Both read
one reference-format ``.npz`` (``--torch_ckpt``; the names of
tests/test_torch_convert.reference_key), since their own checkpoint
formats differ. Bars: result rows as in tests/test_torch_eval.py
(``match_rows``), per-class AP/AR within 1e-6; the CSVs have the same
cells, numbers within 1e-6; ``cli.detect`` the same detection count per
image.
"""
import contextlib
import csv
import functools
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import cl_object_detection_tpu.cli.common as jcommon
import cl_object_detection_tpu.config as jconfig
import cl_object_detection_tpu_torch.cli.common as tcommon
import cl_object_detection_tpu_torch.config as tconfig
from cl_object_detection_tpu.cli import detect as jdetect
from cl_object_detection_tpu.cli import validate as jvalidate
from cl_object_detection_tpu_torch.cli import detect, validate
from cl_object_detection_tpu_torch.cli.train import main as train_main
from cl_object_detection_tpu_torch.train.optim import make_optimizer
from cl_object_detection_tpu_torch.utils.checkpoint import CheckpointManager
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

from test_torch_convert import reference_key
from test_torch_eval import NUM_CLASSES, assert_results_agree, jax_variables, match_rows, port_model

torch.set_num_threads(1)

SMALL = dict(fpn_channels=32, head_layers=2, compute_dtype="float32")
FRAME = ["--image_height", "128", "--image_width", "192", "--min_side", "96",
         "--max_side", "192", "--batch_size", "4"]


@pytest.fixture
def small_models(monkeypatch):
    """Both packages' CLIs build the small float32 model."""
    for mod, cls in ((jcommon, jconfig.ModelConfig), (tcommon, tconfig.ModelConfig),
                     (jconfig, jconfig.ModelConfig), (tconfig, tconfig.ModelConfig)):
        monkeypatch.setattr(mod, "ModelConfig", functools.partial(cls, **SMALL))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy_validate"))
    test_json = make_toy_dataset(root, num_images=12, image_size=(90, 120), seed=3, split="test")
    train_json = make_toy_dataset(root, num_images=8, image_size=(90, 120), seed=4, split="train")
    return dict(root=root, test=test_json, train=train_json, images=os.path.join(root, "images"))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(reference-format npz path, the port model it holds)."""
    _, v = jax_variables(seed=0)
    model = port_model(v)
    path = str(tmp_path_factory.mktemp("npz") / "voc2007_checkpoint_7.npz")
    np.savez(path, **{reference_key(k): t.numpy() for k, t in model.state_dict().items()})
    return path, model


def _args(data, root, *extra):
    return ["--root_dir", root, "--test_json", data["test"], "--image_dir", data["images"],
            "--scenario", "5", "--depth", "18", *FRAME, "--threshold", "0.001",
            "--record", "false", "--cpu", *extra]


def _result_dir(root, *sub):
    return os.path.join(root, "val_result", "5", "state0", *sub)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _cells(path):
    with open(path) as f:
        return list(csv.reader(io.StringIO(f.read())))


def _num(cell):
    try:
        return float(cell.rstrip("%"))
    except ValueError:
        return None


def test_validate_matches_jax_on_a_reference_checkpoint(small_models, data, weights, tmp_path):
    npz, _ = weights
    got = validate.main(_args(data, str(tmp_path / "port"), "--torch_ckpt", npz, "--epoch", "7"))
    jvalidate.main(_args(data, str(tmp_path / "jax"), "--torch_ckpt", npz, "--epoch", "7"))
    name = "voc2007_results_epoch7.json"
    rows = _read_json(_result_dir(str(tmp_path / "port"), name))
    jrows = _read_json(_result_dir(str(tmp_path / "jax"), name))
    pairs = match_rows(rows, jrows)
    assert len(pairs) > 12 * 50

    from cl_object_detection_tpu.data.coco import CocoJson as JCocoJson
    from cl_object_detection_tpu.eval.coco_eval import CocoProtocolEval as JCocoProtocolEval
    from cl_object_detection_tpu_torch.data.coco import CocoJson

    coco = CocoJson(data["test"])
    jev = JCocoProtocolEval(JCocoJson(data["test"]), sorted(coco.imgs))
    want = jev.evaluate(jrows, sorted(coco.classes))
    assert_results_agree(coco, pairs, got[7], want)

    csv_name = "val_result_7.csv"
    cells = _cells(_result_dir(str(tmp_path / "port"), csv_name))
    jcells = _cells(_result_dir(str(tmp_path / "jax"), csv_name))
    assert len(cells) == len(jcells) == 2 + NUM_CLASSES + 4
    for row, jrow in zip(cells, jcells):
        assert len(row) == len(jrow)
        for c, jc in zip(row, jrow):
            if _num(jc) is None:
                assert c == jc
            else:
                assert abs(_num(c) - _num(jc)) <= 1e-6, (row, jrow)


@pytest.fixture
def port_run(small_models, data, weights, tmp_path):
    """A root dir holding port checkpoints for epochs 1 and 2 (the
    reference weights, then the same with random offsets on the
    classification bias), and the validate arguments for it."""
    _, model = weights
    root = str(tmp_path / "run")
    ckpt = CheckpointManager(os.path.join(root, "checkpoint"), ["5"])
    opt = make_optimizer(tconfig.ScheduleConfig(), model)
    ckpt.save(0, 1, model, opt, 0, il_meta={"num_classes": NUM_CLASSES})
    second = port_model(jax_variables(seed=0)[1])
    with torch.no_grad():
        bias = second.classification_head.output.bias
        bias.add_(torch.from_numpy(np.random.RandomState(9).randn(*bias.shape).astype(np.float32)))
    ckpt.save(0, 2, second, opt, 0, il_meta={"num_classes": NUM_CLASSES})
    with open(os.path.join(ckpt.state_dir(0), "params.json"), "w") as f:
        f.write("{}")
    return root, functools.partial(_args, data, root)


def test_validate_epochs_just_val_and_upper_bound(port_run, monkeypatch):
    root, args = port_run
    first = validate.main(args("--epoch", "1", "2"))
    assert sorted(first) == [1, 2]
    for e in (1, 2):
        assert os.path.exists(_result_dir(root, f"voc2007_results_epoch{e}.json"))
    assert os.path.exists(_result_dir(root, "val_result_1_2.csv"))
    assert os.path.exists(_result_dir(root, "params.json"))          # _copy_run_artifacts
    assert first[1].ap50 != first[2].ap50

    # --just_val re-scores the cached rows and predicts nothing
    def no_predict(*a, **k):
        raise AssertionError("--just_val predicted")

    from cl_object_detection_tpu_torch.eval import evaluator as ev_mod

    monkeypatch.setattr(ev_mod.Evaluator, "predict_dataset_multi", no_predict)
    again = validate.main(args("--epoch", "1", "2", "--just_val", "true"))
    for e in (1, 2):
        assert again[e].ap50 == first[e].ap50 and again[e].recall == first[e].recall
    with pytest.raises(SystemExit, match="--just_val: no cached results"):
        validate.main(args("--epoch", "3", "--just_val", "true"))

    # the upper bound, then a decline of 0.0% for that epoch
    validate.main(args("--epoch", "2", "--just_val", "true", "--save_upper_bound", "true"))
    ub = _read_json(os.path.join(root, "val_result", "upper_bound.json"))
    assert ub["mean"]["ap"] == pytest.approx(first[2].mean_ap50)
    validate.main(args("--epoch", "2", "--just_val", "true"))
    rows = {r[0]: r[1:] for r in _cells(_result_dir(root, "val_result_2.csv"))}
    with_gt = [n for n, ap in first[2].ap50.items() if ap >= 0]
    assert with_gt
    for name in with_gt + ["Mean"]:
        assert rows[name][2:4] == ["0.0%", "0.0%"], (name, rows[name])
    assert rows["Sum_decline"][2:4] == ["0.0%", "0.0%"]
    for name in set(first[2].ap50) - set(with_gt):     # no GT: the -1 sentinel stays
        assert rows[name][0] == "-1.0"


def test_validate_new_folder_and_train_split(port_run, data):
    root, args = port_run
    validate.main(args("--epoch", "2", "--new_folder", "true", "--specific_folder", "ab"))
    assert os.path.exists(_result_dir(root, "ab", "voc2007_results_epoch2.json"))
    assert os.path.exists(_result_dir(root, "ab", "val_result_2.csv"))
    # --epoch -1 takes the newest checkpoint
    res = validate.main(args("--epoch", "-1", "--output_csv", "false", "--eval_on_train",
                             "true", "--train_json", data["train"]))
    assert sorted(res) == [2]
    rows = _read_json(_result_dir(root, "voc2007_results_epoch2.json"))
    train_ids = {im["id"] for im in _read_json(data["train"])["images"]}
    assert {r["image_id"] for r in rows} <= train_ids
    assert not os.path.exists(_result_dir(root, "val_result_2.csv"))
    # --ignore_other_img scores each class on the images holding it;
    # --record true writes the hparams summary under runs/
    args_ = args("--epoch", "2", "--just_val", "true", "--new_folder", "true",
                  "--specific_folder", "ab", "--ignore_other_img", "true")
    args_[args_.index("--record") + 1] = "true"
    own = validate.main(args_)
    assert set(own[2].ap50) == set(res[2].ap50)
    assert os.path.isdir(os.path.join(root, "runs"))
    assert any(n.endswith("_val_5_state0") for n in os.listdir(os.path.join(root, "runs")))


def test_validate_quantize_runs(port_run):
    root, args = port_run
    res = validate.main(args("--epoch", "2", "--quantize", "true", "--specific_folder", "q",
                             "--new_folder", "true"))
    assert np.isfinite(res[2].mean_ap50)
    rows = _read_json(_result_dir(root, "q", "voc2007_results_epoch2.json"))
    assert rows and all(np.isfinite(r["score"]) for r in rows)


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--bic", "true"], None, id="flags0-item 4"),
    pytest.param(["--mesh", "true"], "mesh", id="flags1-item 6"),
    pytest.param(["--num_data", "2"], "mesh", id="flags2-item 6"),
    pytest.param(["--topk_method", "approx"], "approx", id="flags3-item 8"),
    pytest.param(["--mesh", "true", "--zero1", "true"], "mesh", id="flags4-item 6b"),
    pytest.param(["--num_model", "2"], "mesh", id="flags5-item 6b"),
])
def test_validate_refuses_what_is_not_ported(small_models, data, weights, tmp_path, capsys,
                                             flags, item):
    """``--zero1`` (item 6b-i, once refused here) is accepted and ignored,
    as JAX's cli.validate ignores it; ``--num_model`` alone (item 6b-ii)
    leaves a run without ``--mesh`` in one process, as JAX's does (the
    model axis's ranks: tests/test_torch_model_axis.py). The data axis (item
    6a, once refused here) runs: ``--mesh true`` on the CPU predicts on a
    one-rank mesh, and ``--num_data`` alone, a size of the mesh's data
    axis, leaves a run without ``--mesh`` in one process, as JAX's does;
    each writes the rows of the plain run (two ranks:
    tests/test_torch_mesh_train.py). ``--bic
    true`` (item 4d, once refused here) runs: on a ``--torch_ckpt`` (no
    meta) it warns that it ignores the flag and writes the uncorrected
    rows without the ``_bic`` suffix, the decline CSV with it.
    ``--topk_method approx`` (item 8, once refused here) runs and writes
    the rows of ``exact`` (the float32 model's logits select the same
    candidates in the same order)."""
    if item == "mesh":
        rows = {}
        for tag, extra in (("plain", ()), ("flag", flags)):
            root = str(tmp_path / tag)
            validate.main(_args(data, root, *extra, "--torch_ckpt", weights[0]))
            rows[tag] = _read_json(_result_dir(root, "voc2007_results_epoch0.json"))
        assert rows["flag"] and rows["flag"] == rows["plain"]
        return
    if item == "approx":
        rows = {}
        for method in ("exact", "approx"):
            root = str(tmp_path / method)
            validate.main(_args(data, root, *flags[:1], method, "--torch_ckpt", weights[0]))
            rows[method] = _read_json(_result_dir(root, "voc2007_results_epoch0.json"))
        assert rows["approx"] and rows["approx"] == rows["exact"]
        return
    if item is None:
        validate.main(_args(data, str(tmp_path), *flags, "--torch_ckpt", weights[0]))
        assert "warning: --bic ignored for --torch_ckpt" in capsys.readouterr().out
        assert os.path.exists(_result_dir(str(tmp_path), "voc2007_results_epoch0.json"))
        assert os.path.exists(_result_dir(str(tmp_path), "val_result_0_bic.csv"))
        return
    with pytest.raises(SystemExit):
        validate.main(_args(data, str(tmp_path), *flags))
    assert item in capsys.readouterr().err
    assert not os.path.exists(os.path.join(str(tmp_path), "val_result"))


def test_validate_without_cpu_or_cuda_raises(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(data, str(tmp_path))
    args.remove("--cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate.main(args)
    assert not os.path.exists(os.path.join(str(tmp_path), "val_result"))


def test_train_val_true_validates_the_last_epoch(small_models, data, tmp_path, capsys):
    """cli.train --cpu --val true: trains two epochs, then validates epoch
    2 (no test split under the root: the train split, with a warning).
    Eight micro-steps at lr 1e-5 leave the zero-initialized output convs
    near zero, so every score stays near the prior 0.01, below the
    default threshold 0.05: no rows, AP 0 for every class."""
    root = str(tmp_path / "run")
    trainer = train_main([
        "--root_dir", root, "--train_json", data["train"], "--image_dir", data["images"],
        "--scenario", "5", "--depth", "18", "--image_height", "64", "--image_width", "64",
        "--min_side", "48", "--max_side", "64", "--batch_size", "2", "--end_epoch", "2",
        "--every_iter", "1", "--record", "false", "--print_il_info", "false", "--cpu",
        "--val", "true"])
    assert trainer.ckpt.epochs(0) == [1, 2]
    assert "warning: no test split found" in capsys.readouterr().out
    assert _read_json(_result_dir(root, "voc2007_results_epoch2.json")) == []
    rows = {r[0]: r[1:] for r in _cells(_result_dir(root, "val_result_2.csv"))}
    assert rows["Epoch"] == ["2"] * 4
    assert all(rows[name][0] == "0.0" for name in trainer.coco.classes.values())
    assert rows["Pred num"][0] == "0"
    assert os.path.exists(_result_dir(root, "params.json"))


def test_train_refuses_val_with_bic(small_models, data, tmp_path):
    """``cli.train --val true --bic true`` (item 4d, once refused here):
    state 0, then state 1 with random replay and BiC, then validation of
    state 1 with the checkpoint's BiC correction, whose rows land in the
    ``_bic`` JSON beside the ``_bic`` decline CSV."""
    root = str(tmp_path / "run")
    try:
        trainer = train_main([
            "--root_dir", root, "--train_json", data["train"], "--image_dir", data["images"],
            "--scenario", "3", "2", "--end_state", "1", "--depth", "18", "--image_height",
            "64", "--image_width", "64", "--min_side", "48", "--max_side", "64",
            "--batch_size", "2", "--end_epoch", "1", "--new_state_epoch", "1", "--every_iter",
            "1", "--sample_num", "1", "--sample_method", "random", "--record", "false",
            "--print_il_info", "false", "--cpu", "--val", "true", "--bic", "true"])
        assert trainer.cur_state == 1 and trainer.bic is not None
        meta = trainer.ckpt.restore(1, 1)[1]
        assert meta["bic"]["alphas"] == trainer.bic.params.alphas.tolist()
        out = os.path.join(root, "val_result", "3_2", "state1")
        assert os.path.exists(os.path.join(out, "voc2007_results_epoch1_bic.json"))
        assert os.path.exists(os.path.join(out, "val_result_1_bic.csv"))
    finally:           # two states of R18 checkpoints, ~260 MB
        shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def small_frames(monkeypatch):
    for mod, cls in ((jconfig, jconfig.DataConfig), (tconfig, tconfig.DataConfig)):
        monkeypatch.setattr(mod, "DataConfig", functools.partial(
            cls, min_side=96, max_side=192, height=128, width=192))


def test_detect_matches_jax(small_models, small_frames, data, weights, tmp_path):
    npz, _ = weights
    images = str(tmp_path / "images")
    os.makedirs(images)
    names = sorted(os.listdir(data["images"]))
    for name in [n for n in names if n.startswith("test_")][:3]:
        with open(os.path.join(data["images"], name), "rb") as f, \
                open(os.path.join(images, name), "wb") as g:
            g.write(f.read())
    common = ["--image_dir", images, "--train_json", data["test"], "--scenario", "5",
              "--depth", "18", "--torch_ckpt", npz, "--score_thresh", "0.15", "--cpu"]
    counts = detect.main(common + ["--out_dir", str(tmp_path / "port")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jdetect.main(common + ["--out_dir", str(tmp_path / "jax")])
    # JAX prints "<name>: <n> detections -> <path>"
    want = {}
    for line in buf.getvalue().splitlines():
        if " detections -> " in line:
            name, rest = line.split(": ", 1)
            want[name] = int(rest.split()[0])
    assert counts == want
    assert sum(counts.values()) > 0
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(images))
    import cv2

    for name in counts:
        got = cv2.imread(str(tmp_path / "port" / name))
        assert got.shape == cv2.imread(str(tmp_path / "jax" / name)).shape


def test_detect_refuses_bic_and_needs_cv2(small_models, small_frames, data, weights, tmp_path,
                                         capsys, monkeypatch):
    """``--bic`` (item 4d, once refused here) runs: on a ``--torch_ckpt``
    (no meta) it warns that it ignores the flag and draws the images;
    without OpenCV the CLI raises naming it."""
    images = str(tmp_path / "images")
    os.makedirs(images)
    name = sorted(n for n in os.listdir(data["images"]) if n.startswith("test_"))[0]
    with open(os.path.join(data["images"], name), "rb") as f, \
            open(os.path.join(images, name), "wb") as g:
        g.write(f.read())
    counts = detect.main(["--image_dir", images, "--train_json", data["test"], "--scenario",
                          "5", "--depth", "18", "--torch_ckpt", weights[0], "--bic", "--cpu",
                          "--out_dir", str(tmp_path / "out")])
    assert "warning: --bic ignored for --torch_ckpt" in capsys.readouterr().out
    assert list(counts) == [name] and os.listdir(tmp_path / "out") == [name]
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="OpenCV"):
        detect.main(["--image_dir", str(tmp_path), "--cpu"])


def test_detect_without_cpu_or_cuda_raises(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect.main(["--image_dir", str(tmp_path), "--train_json", data["test"]])
