"""The port's COCO-protocol evaluator (``eval/coco_eval.py``) and its C++
core (``native/``) against the JAX package's, on the CPU.

Bars (the JAX package's own, tests/test_native.py and
tests/test_coco_protocol_fixture.py):
  * native core against JAX's native core and JAX's Python oracle on
    random problems: atol 1e-9; at an IoU-threshold boundary: atol 0;
  * greedy NMS keep masks: equal;
  * ``CocoProtocolEval`` on the dense 200-image fixture: the Python path
    within 1e-9 of JAX's, the native path within 1e-6;
  * JAX's hand-computed cases (tests/test_coco_eval.py) through the port.
The port's library builds from its own source into ``build/native/``;
``use_native=True`` raises when that build fails, and never answers from
the Python path.
"""
import os

import numpy as np
import pytest

from cl_object_detection_tpu import native as jnative
from cl_object_detection_tpu.data.coco import CocoJson as JCocoJson
from cl_object_detection_tpu.eval.coco_eval import CocoProtocolEval as JCocoProtocolEval
from cl_object_detection_tpu_torch import native
from cl_object_detection_tpu_torch.data.coco import CocoJson
from cl_object_detection_tpu_torch.eval.coco_eval import (
    IOU_THRESHOLDS,
    RECALL_THRESHOLDS,
    CocoProtocolEval,
    EvalResult,
    _iou_xywh,
)

from test_coco_protocol_fixture import N_CLASSES, N_IMAGES, build_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_problem(seed, n_imgs=6, n_det=80, n_gt=15):
    r = np.random.RandomState(seed)
    det_img = r.randint(0, n_imgs, n_det).astype(np.int32)
    det_score = r.rand(n_det).astype(np.float32)
    det_box = np.concatenate(
        [r.rand(n_det, 2) * 80, 5 + r.rand(n_det, 2) * 60], axis=1).astype(np.float32)
    gt_img = r.randint(0, n_imgs, n_gt).astype(np.int32)
    gt_box = np.concatenate(
        [r.rand(n_gt, 2) * 80, 5 + r.rand(n_gt, 2) * 60], axis=1).astype(np.float32)
    for i in range(min(8, n_det, n_gt)):     # some perfect matches
        det_img[i] = gt_img[i]
        det_box[i] = gt_box[i]
        det_score[i] = 0.9 + 0.01 * i
    return det_img, det_score, det_box, gt_img, gt_box, n_imgs


def coco_of(gt_img, gt_box, n_imgs, cls):
    images = [{"id": i + 1, "file_name": f"{i}.jpg", "height": 200, "width": 200}
              for i in range(n_imgs)]
    anns = [{"id": k + 1, "image_id": int(gt_img[k]) + 1, "category_id": 1,
             "bbox": [float(v) for v in gt_box[k]], "area": 1.0, "iscrowd": 0}
            for k in range(len(gt_img))]
    return cls({"images": images, "annotations": anns,
                "categories": [{"id": 1, "name": "x"}]})


def rows_of(det_img, det_score, det_box):
    return [{"image_id": int(det_img[k]) + 1, "category_id": 1,
             "bbox": [float(v) for v in det_box[k]], "score": float(det_score[k])}
            for k in range(len(det_img))]


def both_paths(prob):
    """(port native, port Python, JAX native, JAX Python) of one problem."""
    det_img, det_score, det_box, gt_img, gt_box, n_imgs = prob
    rows = rows_of(det_img, det_score, det_box)
    ids = [i + 1 for i in range(n_imgs)]
    port = CocoProtocolEval(coco_of(gt_img, gt_box, n_imgs, CocoJson), ids)
    jax_ = JCocoProtocolEval(coco_of(gt_img, gt_box, n_imgs, JCocoJson), ids)
    return (native.coco_eval_class_native(*prob),
            port.evaluate_class(rows, 1, use_native=False),
            jnative.coco_eval_class_native(*prob),
            jax_.evaluate_class(rows, 1, use_native=False))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_native_core_matches_jax(seed):
    got, got_py, want, want_py = both_paths(random_problem(seed))
    assert want is not None, "the JAX package's native core did not build"
    np.testing.assert_allclose(got, want, atol=1e-9)
    np.testing.assert_allclose(got, want_py, atol=1e-9)
    np.testing.assert_allclose(got_py, want_py, atol=1e-9)


def test_native_core_at_an_iou_threshold_boundary():
    """IoU exactly 17/20 = 0.85 (a threshold of the grid) and a recall
    grid point: every path gives the same bits."""
    prob = (np.array([0], np.int32), np.array([0.9], np.float32),
            np.array([[0.0, 0.0, 8.5, 2.0]], np.float32), np.array([0], np.int32),
            np.array([[0.0, 0.0, 10.0, 2.0]], np.float32), 1)
    assert 17.0 / 20.0 == IOU_THRESHOLDS[7]
    got, got_py, want, want_py = both_paths(prob)
    np.testing.assert_allclose(got, want, atol=0)
    np.testing.assert_allclose(got, want_py, atol=0)
    np.testing.assert_allclose(got_py, want_py, atol=0)
    assert got == (1.0, 0.8)


def test_native_core_without_gt():
    out = native.coco_eval_class_native(
        np.zeros(3, np.int32), np.ones(3, np.float32), np.ones((3, 4), np.float32),
        np.zeros(0, np.int32), np.zeros((0, 4), np.float32), 4)
    assert out == (-1.0, -1.0)


def test_native_entry_points_check_shapes_before_the_core_reads_them():
    det_img, det_score, det_box, gt_img, gt_box, n = random_problem(0)
    with pytest.raises(ValueError, match="det_box"):
        native.coco_eval_class_native(det_img, det_score, det_box[:-1], gt_img, gt_box, n)
    with pytest.raises(ValueError, match="det_score"):
        native.coco_eval_class_native(det_img, det_score[:-1], det_box, gt_img, gt_box, n)
    with pytest.raises(ValueError, match="gt_box"):
        native.coco_eval_class_native(det_img, det_score, det_box, gt_img, gt_box[:, :3], n)
    with pytest.raises(ValueError, match="boxes"):
        native.greedy_nms_native(det_box[:, :3], det_score, 0.5)
    with pytest.raises(ValueError, match="scores"):
        native.greedy_nms_native(det_box, det_score[:-2], 0.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_nms_matches_jax(seed):
    r = np.random.RandomState(seed)
    n = 128
    boxes = r.rand(n, 4).astype(np.float32) * 100
    boxes[:, 2:] = boxes[:, :2] + 5 + r.rand(n, 2).astype(np.float32) * 40
    scores = np.sort(r.rand(n).astype(np.float32))[::-1].copy()
    scores[100:] = 0
    got = native.greedy_nms_native(boxes, scores, 0.5)
    want = jnative.greedy_nms_native(boxes, scores, 0.5)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 100


@pytest.fixture(scope="module")
def fixture():
    return build_fixture()


@pytest.mark.parametrize("use_native,bar", [(False, 1e-9), (True, 1e-6)])
def test_dense_fixture_matches_jax(fixture, use_native, bar):
    gt, results = fixture
    ids = list(range(N_IMAGES))
    port, jax_ = CocoProtocolEval(gt, ids), JCocoProtocolEval(gt, ids)
    for cid in range(N_CLASSES):
        ap, ar = port.evaluate_class(results, cid, use_native=use_native)
        j_ap, j_ar = jax_.evaluate_class(results, cid, use_native=False)
        assert ap == pytest.approx(j_ap, abs=bar), f"class {cid} AP"
        assert ar == pytest.approx(j_ar, abs=bar), f"class {cid} AR"
        assert 0.0 < ap < 1.0
    got = port.evaluate(results, range(N_CLASSES), use_native=use_native)
    want = jax_.evaluate(results, range(N_CLASSES))
    assert (got.pred_num, got.real_num) == (want.pred_num, want.real_num)
    for name in want.ap50:
        assert got.ap50[name] == pytest.approx(want.ap50[name], abs=bar)
        assert got.recall[name] == pytest.approx(want.recall[name], abs=bar)
    sub = port.evaluate(results, [0, 1], ignore_other_img=True, use_native=use_native)
    jsub = jax_.evaluate(results, [0, 1], ignore_other_img=True)
    assert sub.ap50 == pytest.approx(jsub.ap50, abs=bar)


def test_iou_matches_jax():
    from cl_object_detection_tpu.eval.coco_eval import _iou_xywh as j_iou

    r = np.random.RandomState(5)
    a = np.concatenate([r.rand(40, 2) * 50, 1 + r.rand(40, 2) * 30], 1)
    b = np.concatenate([r.rand(30, 2) * 50, 1 + r.rand(30, 2) * 30], 1)
    np.testing.assert_array_equal(_iou_xywh(a, b), j_iou(a, b))
    from cl_object_detection_tpu.eval import coco_eval as jce

    np.testing.assert_array_equal(IOU_THRESHOLDS, jce.IOU_THRESHOLDS)
    np.testing.assert_array_equal(RECALL_THRESHOLDS, jce.RECALL_THRESHOLDS)


# --------------------------------------------- the JAX package's hand cases

def make_gt():
    return CocoJson({
        "images": [{"id": 1, "file_name": "a.jpg", "height": 100, "width": 100},
                   {"id": 2, "file_name": "b.jpg", "height": 100, "width": 100}],
        "categories": [{"id": 10, "name": "cat"}, {"id": 20, "name": "dog"}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 10, "bbox": [10, 10, 20, 20], "area": 400, "iscrowd": 0},
            {"id": 2, "image_id": 1, "category_id": 10, "bbox": [60, 60, 20, 20], "area": 400, "iscrowd": 0},
            {"id": 3, "image_id": 2, "category_id": 10, "bbox": [30, 30, 30, 30], "area": 900, "iscrowd": 0},
            {"id": 4, "image_id": 2, "category_id": 20, "bbox": [5, 5, 10, 10], "area": 100, "iscrowd": 0},
        ],
    })


def det(img, cat, box, score):
    return {"image_id": img, "category_id": cat, "bbox": box, "score": score}


# (name, image ids, rows, class, image_ids for evaluate_class, ap, ar)
HAND_CASES = [
    ("perfect", [1, 2], [det(1, 10, [10, 10, 20, 20], 0.9), det(1, 10, [60, 60, 20, 20], 0.8),
                         det(2, 10, [30, 30, 30, 30], 0.95)], 10, None, 1.0, 1.0),
    ("fp above tp", [1, 2], [det(2, 20, [50, 50, 10, 10], 0.9), det(2, 20, [5, 5, 10, 10], 0.8)],
     20, None, 0.5, 1.0),
    ("miss one of two", [1], [det(1, 10, [10, 10, 20, 20], 0.9)], 10, [1], 51 / 101, 0.5),
    ("localization", [2], [det(2, 10, [38, 30, 30, 30], 0.9)], 10, [2], 1.0, 0.2),
    ("no gt", [1], [], 20, [1], -1.0, -1.0),
    ("duplicate is fp", [2], [det(2, 20, [5, 5, 10, 10], 0.9), det(2, 20, [5, 5, 10, 10], 0.8)],
     20, [2], 1.0, 1.0),
]


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", HAND_CASES, ids=[c[0] for c in HAND_CASES])
def test_hand_cases(case, use_native):
    _, ids, rows, cat, sub, ap, ar = case
    got = CocoProtocolEval(make_gt(), ids).evaluate_class(rows, cat, image_ids=sub,
                                                          use_native=use_native)
    np.testing.assert_allclose(got, (ap, ar), atol=1e-6)


def test_evaluate_sweep():
    ev = CocoProtocolEval(make_gt(), [1, 2])
    out = ev.evaluate([det(1, 10, [10, 10, 20, 20], 0.9), det(2, 20, [5, 5, 10, 10], 0.9)],
                      [10, 20])
    assert isinstance(out, EvalResult)
    assert set(out.ap50) == {"cat", "dog"}
    assert out.ap50["dog"] == 1.0
    assert (out.pred_num, out.real_num) == (2, 4)
    assert 0 < out.mean_ap50 <= 1


# --------------------------------------------------------------- the build

def test_library_builds_under_build_native():
    path = native.lib_path()
    native.get_lib()
    assert path.exists()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert str(native.BUILD_DIR).startswith(REPO)
    assert path.name.startswith("libcocoeval-") and path.suffix == ".so"
    assert native.SRC == native.BUILD_DIR.parents[1] / "cl_object_detection_tpu_torch" / "native" / "coco_eval.cpp"
    # never JAX's library
    assert "cl_object_detection_tpu/" not in str(path)


def test_failed_build_raises_and_never_answers_from_python(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.get_lib()
    ev = CocoProtocolEval(make_gt(), [1, 2])
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        ev.evaluate_class([det(1, 10, [10, 10, 20, 20], 0.9)], 10)
    with pytest.raises(RuntimeError):
        ev.evaluate([det(1, 10, [10, 10, 20, 20], 0.9)], [10])
    assert not list((tmp_path / "native").glob("*.so"))
    # a compiler that fails outright
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.get_lib()
    # the Python path still answers when asked for
    assert ev.evaluate_class([det(1, 10, [10, 10, 20, 20], 0.9)], 10, image_ids=[1],
                             use_native=False)[0] == pytest.approx(51 / 101)


def test_source_is_the_ports_own_copy():
    with open(native.SRC) as f:
        port = f.read()
    with open(os.path.join(REPO, "cl_object_detection_tpu", "native", "coco_eval.cpp")) as f:
        jax_ = f.read()
    body = port[port.index("#include <algorithm>"):]
    assert body == jax_[jax_.index("#include <algorithm>"):]
