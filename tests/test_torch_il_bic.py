"""The port's BiC against the JAX package's, in float32 on the CPU:
``il/bic.py`` (``class_state_index``, ``make_bic_correct``,
``bic_correct_from_meta``, ``BicTrainer``, ``carve_bic_val_set``), its
Adam against optax, the ``Evaluator`` with a checkpoint's BiC meta, and
``cli.validate --bic`` / ``cli.detect --bic`` on a state-2 checkpoint
that carries BiC scalars. Weights cross from JAX through
``models.bridge``.

Models: R18, FPN 32, 2 head layers, scenario 3+1+1 (5 classes), 64 x 96
RGB frames for the trainer; the toy evaluation split of
tests/test_torch_eval.py for the ``Evaluator`` and the CLIs.

Tolerances:
  * class indices, correction vectors and carved id lists: equal;
  * the corrected logits: equal (one multiply-add per entry);
  * ``BicTrainer.train_epoch``: alphas and betas at rtol 1e-5, the slot
    of an earlier state bit for bit unchanged, the epoch's loss at rtol
    1e-4;
  * the Adam against optax (eager): the optimizer bar of
    tests/test_torch_train_step.py, parameters at rtol 1e-6 plus 1e-5 lr
    per step;
  * detections: the rows of tests/test_torch_eval.py (``match_rows``:
    score within rtol 1e-4, boxes within rtol 1e-4 and atol 1e-3 px).
"""
import functools
import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cl_object_detection_tpu.config as jconfig
import cl_object_detection_tpu_torch.cli.common as tcommon
import cl_object_detection_tpu_torch.config as tconfig
from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.data.coco import CocoJson as JCocoJson
from cl_object_detection_tpu.eval.evaluator import Evaluator as JEvaluator
from cl_object_detection_tpu.il import bic as jbic
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.states import ILStates as JILStates
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.cli import detect, validate
from cl_object_detection_tpu_torch.data.coco import CocoJson
from cl_object_detection_tpu_torch.eval.evaluator import Evaluator
from cl_object_detection_tpu_torch.il import bic
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.states import ILStates
from cl_object_detection_tpu_torch.train.optim import Adam, make_optimizer
from cl_object_detection_tpu_torch.utils.checkpoint import CheckpointManager
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

from test_torch_eval import CFG, DATA, jax_variables, match_rows, port_model

torch.set_num_threads(1)

COUNTS = [3, 1, 1]
C = sum(COUNTS)
H, W = 64, 96
ANCHORS = anchors_for_shape(H, W)
META = {"bic": {"alphas": [1.3, 0.6], "betas": [0.2, -0.4]}}


# ---------------------------------------------------------- the correction

def test_class_state_index_and_correction_equal_jax():
    """JAX's tests/test_il_methods.py case (3+2+1: state-0 classes pass
    through, state-k classes get alpha_{k-1} x + beta_{k-1}) and random
    logits against JAX's correction, bit for bit."""
    np.testing.assert_array_equal(bic.class_state_index([2, 3]), [0, 0, 1, 1, 1])
    for counts in ([3, 2, 1], COUNTS, [2, 3], [5]):
        np.testing.assert_array_equal(bic.class_state_index(counts),
                                      jbic.class_state_index(counts))
    correct = bic.make_bic_correct([3, 2, 1], num_knowing=6)
    out = correct(torch.ones((1, 4, 6)), torch.tensor([2.0, 3.0]), torch.tensor([0.5, -1.0]))
    np.testing.assert_allclose(out[0, 0, :3].numpy(), 1.0)
    np.testing.assert_allclose(out[0, 0, 3:5].numpy(), 2.0 * 1 + 0.5)
    np.testing.assert_allclose(out[0, 0, 5:].numpy(), 3.0 * 1 - 1.0)
    r = np.random.RandomState(0)
    logits = r.randn(2, 7, C).astype(np.float32)
    alphas, betas = r.rand(2).astype(np.float32) + 0.5, r.randn(2).astype(np.float32)
    for num_knowing in (4, 5):
        want = jbic.make_bic_correct(COUNTS, num_knowing)(
            jnp.asarray(logits[..., :num_knowing]), jnp.asarray(alphas), jnp.asarray(betas))
        got = bic.make_bic_correct(COUNTS, num_knowing)(
            torch.from_numpy(logits[..., :num_knowing]), torch.from_numpy(alphas),
            torch.from_numpy(betas))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bic_correct_from_meta_equals_jax():
    """``.scale``/``.offset`` equal JAX's, the callable equals JAX's on
    random logits, and a meta without BiC state gives None."""
    for num_knowing in (3, 4, 5):
        want = jbic.bic_correct_from_meta(META, COUNTS, num_knowing)
        got = bic.bic_correct_from_meta(META, COUNTS, num_knowing)
        np.testing.assert_array_equal(got.scale, want.scale)
        np.testing.assert_array_equal(got.offset, want.offset)
        assert got.scale.dtype == got.offset.dtype == np.float32
        logits = np.random.RandomState(num_knowing).randn(2, 5, num_knowing).astype(np.float32)
        np.testing.assert_array_equal(got(torch.from_numpy(logits)).numpy(),
                                      np.asarray(want(jnp.asarray(logits))))
    np.testing.assert_array_equal(bic.bic_correct_from_meta(META, COUNTS, 5).scale,
                                  np.float32([1, 1, 1, 1.3, 0.6]))
    for meta in (None, {}, {"num_classes": 5}):
        assert bic.bic_correct_from_meta(meta, COUNTS, 5) is None


# ------------------------------------------------------------------ the carve

def test_carve_bic_val_set_equals_jax(tmp_path):
    """Replay blocks of ``sample_num`` and the new classes' training
    images: the held-out ids, their seen-class lists and both remainders
    equal JAX's, for several ratios."""
    root = str(tmp_path)
    json_path = make_toy_dataset(root, num_images=20, image_size=(48, 64), seed=2)
    coco, jcoco = CocoJson(json_path), JCocoJson(json_path)
    new_ids = sorted(coco.classes)[3:]
    train = coco.get_imgs_by_cats(new_ids)
    replay = [i for i in sorted(coco.imgs) if i not in train][:9]
    seen_replay, seen_train = sorted(coco.classes)[:3], sorted(coco.classes)
    for sample_num, ratio in ((3, 0.4), (2, 0.1), (3, 0.7), (4, 0.5)):
        args = (train, replay, seen_replay, seen_train, new_ids)
        got = bic.carve_bic_val_set(*args, coco, sample_num, ratio)
        want = jbic.carve_bic_val_set(*args, jcoco, sample_num, ratio)
        assert got == want
        assert got[0] and set(got[0]).isdisjoint(got[2]) and set(got[0]).isdisjoint(got[3])
        assert sorted(got[0] + got[2] + got[3]) == sorted(set(train) | set(replay))


# ------------------------------------------------------------- the trainer

def _jax_model():
    model = j_create(jcfg.ModelConfig(**CFG), C)
    _, v = jax_variables(seed=2)
    return model, jax.tree.map(np.asarray, v)


def _batch(seed, n=2):
    r = np.random.RandomState(seed)
    img = r.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    x = ((img.astype(np.float32) / 255.0 - 0.45) / 0.225).astype(np.float32)
    boxes = np.full((n, 4, 4), -1, np.float32)
    labels = np.full((n, 4), -1, np.int32)
    for b in range(n):
        for j, lab in enumerate((4, 3, b)):
            x1, y1 = r.uniform(0, 50), r.uniform(0, 25)
            boxes[b, j] = [x1, y1, x1 + r.uniform(20, 45), y1 + r.uniform(20, 38)]
            labels[b, j] = lab
    return SimpleNamespace(images=x, boxes=boxes, labels=labels)


class ListLoader(list):
    """A loader over fixed batches."""


def test_bic_trainer_epoch_matches_jax():
    """Two epochs of the state-2 scalars over two held-out batches, from
    carried state-1 scalars (1.3, 0.2): alphas and betas at rtol 1e-5
    against JAX's BicTrainer, the state-1 slot unchanged bit for bit, the
    state-2 slot moved off (1, 0), each epoch's loss at rtol 1e-4; the
    detector's parameters untouched and without gradient."""
    model, v = _jax_model()
    loader = ListLoader([_batch(1), _batch(2)])
    args = (jcfg.ILConfig(), jcfg.FocalConfig(), jcfg.BiCConfig(), COUNTS, 2, 4, loader)
    jt = jbic.BicTrainer(model, ANCHORS, *args)
    jt.params.load({"alphas": [1.3, 1.0], "betas": [0.2, 0.0]})
    pm = create_retinanet(tcfg.ModelConfig(**CFG), C, device="cpu")
    load_jax_variables(pm, v)
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    pt = bic.BicTrainer(pm, ANCHORS, tcfg.ILConfig(), tcfg.FocalConfig(), tcfg.BiCConfig(),
                        COUNTS, 2, 4, loader)
    pt.params.load({"alphas": [1.3, 1.0], "betas": [0.2, 0.0]})
    jv = jax.tree.map(jnp.asarray, v)
    for _ in range(2):
        want_loss = jt.train_epoch(jv)
        got_loss = pt.train_epoch()
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
        for what in ("alphas", "betas"):
            got = getattr(pt.params, what).numpy()
            want = np.asarray(getattr(jt.params, what))
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=what)
    assert pt.params.alphas[0].item() == np.float32(1.3)
    assert pt.params.betas[0].item() == np.float32(0.2)
    assert pt.params.alphas[1] != 1.0 and pt.params.betas[1] != 0.0
    for k, t in pm.state_dict().items():
        assert torch.equal(t, before[k]), k
    assert all(p.grad is None for p in pm.parameters())
    # the correction closure carries the trained scalars
    logits = torch.zeros(1, 2, C)
    np.testing.assert_array_equal(pt.correction_fn()(logits)[0, 0].numpy(),
                                  np.float32([0, 0, 0, 0.2, pt.params.betas[1].item()]))


def test_bic_adam_matches_optax():
    """The port's Adam on the two scalar vectors, the gradient masked to
    one slot, against ``optax.adam(1e-3)`` (eager) over six steps."""
    lr = 1e-3
    r = np.random.RandomState(3)
    tree = {"alphas": np.float32([1.3, 1.0]), "betas": np.float32([0.2, 0.0])}
    opt = optax.adam(lr)
    state = opt.init(jax.tree.map(jnp.asarray, tree))
    jtree = jax.tree.map(jnp.asarray, tree)
    leaves = [torch.nn.Parameter(torch.from_numpy(tree[k].copy())) for k in ("alphas", "betas")]
    adam = Adam([{"name": "bic", "params": leaves, "lr": lr}], lr=lr)
    mask = np.float32([0, 1])
    for t in range(1, 7):
        g = {k: (r.randn(2) * 10.0 ** r.randint(-3, 1)).astype(np.float32) * mask
             for k in ("alphas", "betas")}
        with jax.disable_jit():
            upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jtree)
            jtree = optax.apply_updates(jtree, upd)
        for leaf, k in zip(leaves, ("alphas", "betas")):
            leaf.grad = torch.from_numpy(g[k])
        adam.step()
        for leaf, k in zip(leaves, ("alphas", "betas")):
            want = np.asarray(jtree[k])
            np.testing.assert_allclose(leaf.detach().numpy(), want,
                                       rtol=1e-6, atol=1e-5 * lr * t, err_msg=k)
            assert leaf[0].item() == tree[k][0]
        mu = adam.state[leaves[0]]["mu"].numpy()
        np.testing.assert_allclose(mu, np.asarray(state[0].mu["alphas"]), rtol=1e-6)


# ----------------------------------------------------- evaluation with BiC

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy_bic_eval"))
    json_path = make_toy_dataset(root, num_images=12, image_size=(90, 120), seed=3, split="test")
    return json_path, os.path.join(root, "images")


def _evaluators(split):
    json_path, images = split
    jcoco, coco = JCocoJson(json_path), CocoJson(json_path)
    scenario = [str(n) for n in COUNTS]
    jstates = JILStates(list(jcoco.classes.values()), jcoco.classes_inverse, scenario)
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, scenario)
    kw = dict(score_thresh=1e-3, max_detections=50)
    return (JEvaluator(jcoco, jstates, images, jconfig.DataConfig(**DATA),
                       jconfig.PredictConfig(**kw), state_index=2),
            Evaluator(coco, states, images, tconfig.DataConfig(**DATA),
                      tconfig.PredictConfig(**kw), state_index=2))


def test_evaluator_with_checkpoint_bic_meta_matches_jax(split):
    """A checkpoint's BiC meta (state-1 and state-2 slots off (1, 0)):
    the port's ``Evaluator`` through both of its forms (the runtime
    vectors of ``predict_dataset_multi``, the callable of
    ``predict_dataset``) against JAX's ``predict_dataset`` with JAX's
    ``bic_correct_from_meta``; the corrected rows differ from the
    uncorrected ones."""
    jmodel, v = jax_variables(seed=0)
    jev, ev = _evaluators(split)
    want = jev.predict_dataset(jmodel, jax.tree.map(jnp.asarray, v),
                               bic_correct=jbic.bic_correct_from_meta(META, COUNTS, C))
    model = port_model(v)
    bc = bic.bic_correct_from_meta(META, COUNTS, C)
    multi = ev.predict_dataset_multi({1: model, 2: model}, bic_correct_by_key={2: bc})
    single = ev.predict_dataset(model, bic_correct=bc)
    assert len(want) > 12 * 20
    for got in (multi[2], single):
        match_rows(got, want)
    plain = multi[1]
    assert plain != multi[2]
    assert plain == ev.predict_dataset(model)


# ------------------------------------------------------------- the CLIs

SMALL = dict(fpn_channels=32, head_layers=2, compute_dtype="float32")


@pytest.fixture
def small_models(monkeypatch):
    for mod, cls in ((tcommon, tconfig.ModelConfig), (tconfig, tconfig.ModelConfig)):
        monkeypatch.setattr(mod, "ModelConfig", functools.partial(cls, **SMALL))


@pytest.fixture
def bic_run(split, tmp_path):
    """A run dir of scenario 3+1+1 holding a state-2 checkpoint: epoch 1
    with BiC scalars in its meta, epoch 2 without; emptied after the
    test."""
    json_path, images = split
    root = str(tmp_path / "run")
    ckpt = CheckpointManager(os.path.join(root, "checkpoint"), [str(n) for n in COUNTS])
    model = port_model(jax_variables(seed=0)[1])
    opt = make_optimizer(tconfig.ScheduleConfig(), model)
    ckpt.save(2, 1, model, opt, 0, il_meta={"num_classes": C, **META})
    ckpt.save(2, 2, model, opt, 0, il_meta={"num_classes": C})
    args = ["--root_dir", root, "--test_json", json_path, "--image_dir", images,
            "--scenario", *map(str, COUNTS), "--state", "2", "--depth", "18",
            "--image_height", "128", "--image_width", "192", "--min_side", "96",
            "--max_side", "192", "--batch_size", "4", "--threshold", "0.001",
            "--record", "false", "--cpu"]
    yield root, args
    shutil.rmtree(tmp_path, ignore_errors=True)


def _val_dir(root, *sub):
    return os.path.join(root, "val_result", "_".join(map(str, COUNTS)), "state2", *sub)


def test_validate_bic_writes_bic_results(small_models, bic_run, capsys):
    """``cli.validate --state 2 --bic true`` over an epoch with BiC meta
    and one without: the first's rows go to the ``_bic`` JSON and differ
    from the plain run's, the second's (uncorrected, with a warning) to
    the JSON without the suffix; the decline CSV carries ``_bic``;
    ``--just_val`` reads the ``_bic`` rows back."""
    root, args = bic_run
    plain = validate.main(args + ["--epoch", "1"])
    with open(_val_dir(root, "voc2007_results_epoch1.json")) as f:
        plain_rows = json.load(f)
    os.remove(_val_dir(root, "voc2007_results_epoch1.json"))
    res = validate.main(args + ["--epoch", "1", "2", "--bic", "true"])
    assert "epoch 2 checkpoint carries no BiC state" in capsys.readouterr().out
    with open(_val_dir(root, "voc2007_results_epoch1_bic.json")) as f:
        bic_rows = json.load(f)
    assert not os.path.exists(_val_dir(root, "voc2007_results_epoch1.json"))
    assert os.path.exists(_val_dir(root, "voc2007_results_epoch2.json"))
    assert not os.path.exists(_val_dir(root, "voc2007_results_epoch2_bic.json"))
    assert os.path.exists(_val_dir(root, "val_result_1_2_bic.csv"))
    assert bic_rows and bic_rows != plain_rows
    assert res[1].ap50 != plain[1].ap50 or res[1].recall != plain[1].recall \
        or res[1].pred_num != plain[1].pred_num
    again = validate.main(args + ["--epoch", "1", "--bic", "true", "--just_val", "true"])
    assert again[1].ap50 == res[1].ap50


def test_validate_bic_warns_under_torch_ckpt(small_models, bic_run, tmp_path, capsys):
    root, args = bic_run
    npz = str(tmp_path / "ref.npz")
    from test_torch_convert import reference_key

    model = port_model(jax_variables(seed=0)[1])
    np.savez(npz, **{reference_key(k): t.numpy() for k, t in model.state_dict().items()})
    validate.main(args + ["--torch_ckpt", npz, "--epoch", "4", "--bic", "true"])
    assert "warning: --bic ignored for --torch_ckpt" in capsys.readouterr().out
    assert os.path.exists(_val_dir(root, "voc2007_results_epoch4.json"))
    assert os.path.exists(_val_dir(root, "val_result_4_bic.csv"))


def test_detect_bic_applies_the_checkpoint_scalars(small_models, bic_run, split, tmp_path,
                                                   monkeypatch):
    """``cli.detect --bic`` on the state-2 checkpoint with BiC meta: the
    detections differ from the uncorrected run's, and the scalars reach
    the predict function as JAX's ``bic_correct_from_meta`` makes them."""
    pytest.importorskip("cv2")
    root, _ = bic_run
    json_path, images = split
    monkeypatch.setattr(tconfig, "DataConfig", functools.partial(
        tconfig.DataConfig, min_side=96, max_side=192, height=128, width=192))
    seen = []
    real = bic.bic_correct_from_meta

    def spy(meta, counts, num_knowing):
        fn = real(meta, counts, num_knowing)
        seen.append((counts, num_knowing, fn.scale.tolist(), fn.offset.tolist()))
        return fn

    monkeypatch.setattr(bic, "bic_correct_from_meta", spy)
    common = ["--image_dir", images, "--train_json", json_path, "--root_dir", root,
              "--scenario", *map(str, COUNTS), "--state", "2", "--epoch", "1", "--depth", "18",
              "--score_thresh", "0.15", "--cpu"]
    plain = detect.main(common + ["--out_dir", str(tmp_path / "plain")])
    corrected = detect.main(common + ["--out_dir", str(tmp_path / "bic"), "--bic"])
    want = jbic.bic_correct_from_meta(META, COUNTS, C)
    assert seen == [(COUNTS, C, want.scale.tolist(), want.offset.tolist())]
    assert sum(plain.values()) > 0 and corrected != plain
    assert sorted(os.listdir(tmp_path / "bic")) == sorted(plain)
