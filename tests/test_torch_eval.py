"""The port's evaluation slice (``eval/predictor.detections_to_coco``,
``eval/evaluator.Evaluator``, ``eval/report.py``) against the JAX
package's, on the CPU.

Bars:
  * ``detections_to_coco`` on the same numpy detections, scales, ids and
    ``keep_slots``: the rows are equal (``==`` on the dicts);
  * the slice as a whole (``Evaluator.run`` of both packages on a toy
    test split, R18 / FPN 32 / 2 head layers in float32, the same weights
    carried across by ``models.bridge.load_jax_variables``, random output
    convs and a raised classification bias so that every image has
    detections at ``score_thresh`` 1e-3): the rows match one to one, the
    same ``image_id`` and ``category_id`` with ``bbox`` and ``score``
    within rtol 1e-4 (the predict bar, tests/test_torch_predict.py) and
    atol 1e-3 px; per-class AP and AR within 1e-6; ``pred_num`` and
    ``real_num`` equal. Where an AP differs by more, the test passes only
    if it finds the flipped match, a row whose IoU lies within 1e-4 of an
    IoU threshold;
  * ``eval/report.py``: byte-equal CSV and JSON.
"""
import json
import os
import pickle
from collections import defaultdict, namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.config import DataConfig as JDataConfig
from cl_object_detection_tpu.config import ModelConfig as JModelConfig
from cl_object_detection_tpu.config import PredictConfig as JPredictConfig
from cl_object_detection_tpu.data.coco import CocoJson as JCocoJson
from cl_object_detection_tpu.eval import report as jreport
from cl_object_detection_tpu.eval.coco_eval import EvalResult as JEvalResult
from cl_object_detection_tpu.eval.evaluator import Evaluator as JEvaluator
from cl_object_detection_tpu.eval.predictor import detections_to_coco as j_detections_to_coco
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.states import ILStates as JILStates
from cl_object_detection_tpu_torch.config import DataConfig, ModelConfig, PredictConfig
from cl_object_detection_tpu_torch.data.coco import CocoJson
from cl_object_detection_tpu_torch.eval import report
from cl_object_detection_tpu_torch.eval.coco_eval import IOU_THRESHOLDS, EvalResult, _iou_xywh
from cl_object_detection_tpu_torch.eval.evaluator import Evaluator
from cl_object_detection_tpu_torch.eval.predictor import detections_to_coco
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.ops.nms import Detections
from cl_object_detection_tpu_torch.states import ILStates
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

torch.set_num_threads(1)

CFG = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
NUM_CLASSES = 5
DATA = dict(batch_size=4, min_side=96, max_side=192, height=128, width=192, max_boxes=8,
            num_workers=0, prefetch=0)
THRESH = 1e-3


# ------------------------------------------------------------ detections_to_coco

def _random_detections(seed, b=3, d=12):
    r = np.random.RandomState(seed)
    xy = r.rand(b, d, 2).astype(np.float32) * 150
    wh = 1 + r.rand(b, d, 2).astype(np.float32) * 60
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = r.rand(b, d).astype(np.float32)
    labels = r.randint(0, NUM_CLASSES, (b, d)).astype(np.int32)
    valid = r.rand(b, d) > 0.2
    return boxes, scores, labels, valid


BatchIds = namedtuple("BatchIds", "image_ids scales")
JDet = namedtuple("JDet", "boxes scores labels valid")


@pytest.mark.parametrize("keep_slots", [None, [True, True, False, True]])
@pytest.mark.parametrize("score_thresh", [0.05, 0.5])
def test_detections_to_coco_matches_jax(keep_slots, score_thresh):
    boxes, scores, labels, valid = _random_detections(0, b=4)
    batch = BatchIds(image_ids=np.array([5, -1, 7, 9], np.int64),
                     scales=np.array([1.3, 1.0, 0.7, 1.0 / 3.0], np.float32))
    label_to_cat = {i: 10 + 2 * i for i in range(NUM_CLASSES)}
    want = j_detections_to_coco(JDet(boxes, scores, labels, valid), batch, label_to_cat,
                                score_thresh, keep_slots=keep_slots)
    got = detections_to_coco(
        Detections(*(torch.from_numpy(a) for a in (boxes, scores, labels, valid))),
        batch, label_to_cat, score_thresh, keep_slots=keep_slots)
    assert len(want) >= 4
    assert got == want
    # the same bytes: float32 division on the host
    assert json.dumps(got) == json.dumps(want)


# ------------------------------------------------------------------ the models

def jax_variables(seed):
    """flax init of the small R18 with random output convs, scaled so the
    logits have std near 1 and the box deltas near 0.3 (the trunk's
    features are large at He init), and the classification bias raised
    to -2: scores spread around 0.12."""
    model = j_create(JModelConfig(**CFG), NUM_CLASSES)
    v = jax.tree.map(np.array, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3))))
    r = np.random.RandomState(seed + 100)
    for head, std, bias in (("classification_head", 1e-3, -2.0), ("regression_head", 2.5e-4, 0.0)):
        out = v["params"][head]["output"]
        out["kernel"] = (r.randn(*out["kernel"].shape) * std).astype(np.float32)
        out["bias"] = (r.randn(*out["bias"].shape) * 0.05 + bias).astype(np.float32)
    return model, v


def port_model(v):
    model = create_retinanet(ModelConfig(**CFG), NUM_CLASSES, device="cpu")
    load_jax_variables(model, v)
    return model


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy_eval"))
    json_path = make_toy_dataset(root, num_images=12, image_size=(90, 120), seed=3, split="test")
    return json_path, os.path.join(root, "images")


def evaluators(split, **predict):
    json_path, images = split
    jcoco, coco = JCocoJson(json_path), CocoJson(json_path)
    jstates = JILStates(list(jcoco.classes.values()), jcoco.classes_inverse, ["5"])
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, ["5"])
    kw = dict(score_thresh=THRESH, **predict)
    return (JEvaluator(jcoco, jstates, images, JDataConfig(**DATA), JPredictConfig(**kw)),
            Evaluator(coco, states, images, DataConfig(**DATA), PredictConfig(**kw)))


def match_rows(got, want):
    """Match each JAX row to a port row of the same image and category
    with bbox and score within the bars; returns [(port, jax)]."""
    assert len(got) == len(want)
    by_key = defaultdict(list)
    for r in got:
        by_key[(r["image_id"], r["category_id"])].append(r)
    pairs = []
    for w in sorted(want, key=lambda r: -r["score"]):
        cands = by_key[(w["image_id"], w["category_id"])]
        for i, g in enumerate(cands):
            if (abs(g["score"] - w["score"]) <= 1e-4 * abs(w["score"])
                    and np.allclose(g["bbox"], w["bbox"], rtol=1e-4, atol=1e-3)):
                pairs.append((cands.pop(i), w))
                break
        else:
            raise AssertionError(f"no port row matches the JAX row {w}")
    return pairs


def flipped_matches(coco, pairs, cat_id):
    """Rows of ``cat_id`` whose best IoU with a GT box of their image lies
    on either side of an IoU threshold in the two packages: [(threshold,
    port IoU, JAX IoU)]."""
    out = []
    for g, w in pairs:
        if w["category_id"] != cat_id:
            continue
        gts = [a["bbox"] for a in coco.get_anns_by_img(w["image_id"])
               if a["category_id"] == cat_id]
        if not gts:
            continue
        gts = np.asarray(gts, np.float64)
        ig = _iou_xywh(np.asarray([g["bbox"]], np.float64), gts).max()
        iw = _iou_xywh(np.asarray([w["bbox"]], np.float64), gts).max()
        out += [(t, ig, iw) for t in IOU_THRESHOLDS if (ig >= t) != (iw >= t)]
    return out


def assert_results_agree(coco, pairs, got: EvalResult, want, bar=1e-6):
    assert (got.pred_num, got.real_num) == (want.pred_num, want.real_num)
    assert set(got.ap50) == set(want.ap50)
    for name in want.ap50:
        for what in ("ap50", "recall"):
            g, w = getattr(got, what)[name], getattr(want, what)[name]
            if abs(g - w) > bar:
                flips = flipped_matches(coco, pairs, coco.classes_inverse[name])
                assert flips, f"{name} {what}: {g} against {w} with no flipped match"
                assert all(min(abs(ig - t), abs(iw - t)) <= 1e-4 for t, ig, iw in flips), flips


def test_evaluator_run_matches_jax(split, tmp_path):
    """The slice as a whole: Evaluator.run of both packages (result JSON,
    rows, per-class AP/AR, counts)."""
    jmodel, v = jax_variables(seed=0)
    jev, ev = evaluators(split)
    want = jev.run(jmodel, jax.tree.map(jnp.asarray, v), result_dir=str(tmp_path / "jax"), epoch=3)
    got = ev.run(port_model(v), result_dir=str(tmp_path / "port"), epoch=3)
    name = "voc2007_results_epoch3.json"
    with open(tmp_path / "jax" / name) as f:
        want_rows = json.load(f)
    with open(tmp_path / "port" / name) as f:
        got_rows = json.load(f)
    assert len(want_rows) > 12 * 50
    assert {r["image_id"] for r in got_rows} == set(ev.dataset.image_ids)
    pairs = match_rows(got_rows, want_rows)
    assert_results_agree(ev.coco, pairs, got, want)
    assert any(0 < ap < 1 for ap in got.ap50.values()), got.ap50


def test_predict_dataset_multi_matches_jax(split):
    """Two weight sets through one decode pass, against JAX's; the second
    with a per-class correction (``.scale``/``.offset`` on the logits,
    the form of the BiC correction), the first with the identity."""
    (jmodel, v1), (_, v2) = jax_variables(seed=0), jax_variables(seed=1)
    jev, ev = evaluators(split, max_detections=50)
    corr = namedtuple("Correction", "scale offset")(
        np.array([1.0, 0.5, 2.0, 1.0, 0.8], np.float32),
        np.array([0.0, 0.3, -0.2, 0.1, 0.0], np.float32))
    want = jev.predict_dataset_multi(jmodel, {1: jax.tree.map(jnp.asarray, v1),
                                              2: jax.tree.map(jnp.asarray, v2)},
                                     bic_correct_by_key={2: corr})
    got = ev.predict_dataset_multi({1: port_model(v1), 2: port_model(v2)},
                                   bic_correct_by_key={2: corr})
    assert set(got) == {1, 2}
    for key in (1, 2):
        pairs = match_rows(got[key], want[key])
        assert_results_agree(ev.coco, pairs, ev.evaluate(got[key]), jev.evaluate(want[key]))
    assert got[1] != got[2]
    # one model alone gives the rows of its key (the identity class affine
    # leaves the logits unchanged)
    assert ev.predict_dataset(port_model(v1)) == got[1]


def test_predict_dataset_dedups_wrap_slots(tmp_path):
    """A batch of 8 over 3 images repeats each image inside the batch; each
    image's rows are emitted once (the JAX package's tests/test_eval_dedup.py)."""
    root = str(tmp_path)
    make_toy_dataset(root, num_images=3, seed=2, split="train")
    coco = CocoJson(os.path.join(root, "train.json"))
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, ["5"])
    data_cfg = DataConfig(batch_size=8, min_side=100, max_side=192, height=128, width=192,
                          max_boxes=8, num_workers=0, prefetch=0)
    ev = Evaluator(coco, states, os.path.join(root, "images"), data_cfg,
                   PredictConfig(score_thresh=1e-4, max_detections=20),
                   state_index=0, eval_on_train=True)
    model = create_retinanet(ModelConfig(depth=18, compute_dtype="float32"), 5, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    batch = next(iter(ev.loader))
    ids = batch.image_ids.tolist()
    assert len(set(ids)) < len(ids), "fixture must wrap-fill within a batch"

    rows = ev.predict_dataset(model)
    keys = [(r["image_id"], tuple(r["bbox"]), r["score"]) for r in rows]
    assert len(keys) == len(set(keys)) == 3 * 20
    multi = ev.predict_dataset_multi({0: model})
    keys = [(r["image_id"], tuple(r["bbox"]), r["score"]) for r in multi[0]]
    assert len(keys) == len(set(keys))
    assert multi[0] == rows


def test_evaluator_refuses_a_mesh(split, monkeypatch):
    """The mesh (ROADMAP §1 item 6a, once refused here): two ranks, run
    one after the other in this process with the gather between them
    stubbed, each predict their slice of every batch; the gathered rows
    equal one process's, in its order, for ``predict_dataset`` and
    ``predict_dataset_multi``. (Real ranks: tests/test_torch_mesh_train.py.)"""
    from cl_object_detection_tpu_torch.eval import evaluator as evaluator_mod
    from cl_object_detection_tpu_torch.parallel.mesh import DataMesh

    _, ev = evaluators(split)
    model = create_retinanet(ModelConfig(**CFG), NUM_CLASSES, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    want = ev.predict_dataset(model)
    assert want
    gathered = {}

    def all_gather_object(mesh, obj):
        gathered[mesh.rank] = obj
        return [gathered.get(r, []) for r in range(mesh.world)]

    monkeypatch.setattr(evaluator_mod, "all_gather_object", all_gather_object)
    meshes = [DataMesh(rank=r, world=2, device=torch.device("cpu"), backend="gloo")
              for r in (1, 0)]
    for call in (lambda m: ev.predict_dataset(model, mesh=m),
                 lambda m: ev.predict_dataset_multi({0: model}, mesh=m)[0]):
        gathered.clear()
        got = [call(m) for m in meshes][-1]               # rank 0's, after rank 1's
        assert got == want
        assert len(gathered[1]) == len(gathered[0]) == len(ev.loader) * DATA["batch_size"] // 2


def test_progress_prints_without_tqdm(split, monkeypatch, capsys):
    import builtins

    real_import = builtins.__import__

    def no_tqdm(name, *args, **kw):
        if name == "tqdm":
            raise ImportError("no tqdm")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tqdm)
    _, ev = evaluators(split, max_detections=5)
    model = create_retinanet(ModelConfig(**CFG), NUM_CLASSES, device="cpu")
    rows = ev.predict_dataset(model, progress=True)
    out = capsys.readouterr().out
    assert f"eval: batch {len(ev.loader)}/{len(ev.loader)}" in out
    assert len(rows) == 12 * 5


# ---------------------------------------------------------------- eval/report

def results_pair(ap, sentinel=False):
    """The same EvalResult in both packages' types."""
    out = []
    for cls in (EvalResult, JEvalResult):
        r = cls()
        r.ap50 = {"a": ap, "b": ap / 2, "c": 1.0 / 3.0}
        r.recall = {"a": ap, "b": ap, "c": 0.7}
        if sentinel:
            r.ap50["b"] = r.recall["b"] = -1.0
        r.pred_num, r.real_num = 10, 7
        out.append(r)
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("sentinel", [False, True])
def test_report_matches_jax(tmp_path, sentinel):
    ub, jub = results_pair(0.8, sentinel)
    report.save_upper_bound(str(tmp_path / "port" / "upper_bound.json"), ub)
    jreport.save_upper_bound(str(tmp_path / "jax" / "upper_bound.json"), jub)
    assert _read(tmp_path / "port" / "upper_bound.json") == _read(tmp_path / "jax" / "upper_bound.json")
    loaded = report.load_upper_bound(str(tmp_path / "port" / "upper_bound.json"))
    assert loaded == jreport.load_upper_bound(str(tmp_path / "jax" / "upper_bound.json"))
    assert ("b" in loaded) is not sentinel

    ten, jten = results_pair(0.6, sentinel)
    twenty, jtwenty = results_pair(0.7)
    text = report.decline_csv({20: twenty, 10: ten}, ["a", "b", "c"], 2, upper_bound=loaded,
                              out_path=str(tmp_path / "port" / "r.csv"))
    jtext = jreport.decline_csv({20: jtwenty, 10: jten}, ["a", "b", "c"], 2, upper_bound=loaded,
                                out_path=str(tmp_path / "jax" / "r.csv"))
    assert text == jtext
    assert _read(tmp_path / "port" / "r.csv") == _read(tmp_path / "jax" / "r.csv")
    assert text.splitlines()[0] == "Epoch,10,10,10,10,20,20,20,20"
    if sentinel:
        b_row = next(line for line in text.splitlines() if line.startswith("b,"))
        assert b_row.startswith("b,-1.0,-1.0,")
    # no upper bound at all
    assert report.decline_csv({10: ten}, ["a", "b", "c"], 1) == \
        jreport.decline_csv({10: jten}, ["a", "b", "c"], 1)


def test_upper_bound_pickle_fallback(tmp_path):
    raw = {"a": {"ap": 0.5, "recall": 0.25}, "b": {"ap": 0.75, "recall": 0.5}, "skip": 3}
    with open(tmp_path / "upper_bound.pickle", "wb") as f:
        pickle.dump(raw, f)
    path = str(tmp_path / "upper_bound.json")
    got = report.load_upper_bound(path)
    assert got == jreport.load_upper_bound(path)
    assert got["mean"] == {"ap": 0.625, "recall": 0.375}
    assert report.load_upper_bound(str(tmp_path / "none" / "upper_bound.json")) is None
