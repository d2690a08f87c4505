"""The port's replay, exemplars, prototypes and pseudo-labels against the
JAX package's, in float32 on the CPU: ``models/retinanet.unfold3x3`` and
``RetinaNet.classification_features``, ``il/herding.py``,
``il/prototype.py``, ``il/pseudo_label.py``, the prototype term of
``il/losses.compute_losses`` and the trainer's replay, prototype and
pseudo-label tools from state 0 into state 1 (``train/trainer.py``,
``train/loop.py``). Weights cross from JAX through ``models.bridge``.

Models: R18, FPN 32, 2 head layers, 3 old + 2 new classes, 128 x 128
frames. The toy set holds square 96 x 96 PNG images (``min_side`` =
``max_side`` = 96: scale 1, so both packages' loaders give the same
batches); its boxes are at most half the image's side, so herding runs
at ``herd_ratio_threshold`` 0.05 (at the default 0.25 no image would be
eligible) and the tests assert a full exemplar set.

Tolerances:
  * ``unfold3x3``: bit for bit (it moves data); ``classification_features``
    at rtol = atol = 2e-4 (the forward's bar, tests/test_torch_model.py),
    the FPN maps and the unfolded trunk features with atol 2e-4 of their
    largest |value| (they reach ~30 on this model, and float32 rounding
    through the backbone, FPN and trunk grows with them);
  * ``foreground_ratio``: exact (the same numpy operations);
  * the bilinear resize: the weights at rtol 1e-6 against JAX's eager
    ones (bit for bit when growing; shrinking sums ~9 weights per output
    in another order), the result against their float64 product at
    rtol 1e-5, and
    against ``jax.image.resize`` at rtol 1e-5 with atol 1e-5 of the
    input's largest |value|: jitted, XLA rounds JAX's own weights by up
    to ~2e-6 relative (fused multiply-adds on some lanes), so an output
    that cancels to near zero carries that error in absolute terms;
  * the herding feature vector at rtol 1e-4 with atol 1e-4 of its largest
    |value| (the resize's reason); exemplar ids equal;
  * ``compute_prototype_features`` at rtol 1e-4, atol 1e-5 of its
    largest |value| (the trunk's scale, as above);
    ``prototype_loss_from_batch`` and its gradient against
    ``jax.value_and_grad`` at rtol 1e-4; prototype-herd picks equal, the
    distances at rtol 1e-4, atol 1e-4 of the largest (an image alone in
    its slot is at distance 0 from JAX's prototype in JAX, ~1e-3 in the
    port, whose features differ from JAX's by the forward's rounding);
  * ``generate_pseudo_labels``: the same images, counts, classes; boxes
    and scores at rtol 1e-4;
  * the trainer: every micro-step's total_loss at rtol 1e-4, lr 1e-5
    (tests/test_torch_trainer.py's bars), exemplar ids equal.
"""
import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.data.coco import CocoJson as JCocoJson
from cl_object_detection_tpu.data.dataset import ILDataset as JILDataset
from cl_object_detection_tpu.data.loader import BatchLoader as JBatchLoader
from cl_object_detection_tpu.il import herding as jherding
from cl_object_detection_tpu.il import prototype as jproto
from cl_object_detection_tpu.il.pseudo_label import generate_pseudo_labels as j_pseudo
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.models.retinanet import unfold3x3 as j_unfold3x3
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.states import ILStates as JILStates
from cl_object_detection_tpu.train.loop import train_process as j_train_process
from cl_object_detection_tpu.train.trainer import ILTrainer as JILTrainer
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.data.coco import CocoJson
from cl_object_detection_tpu_torch.data.dataset import ILDataset
from cl_object_detection_tpu_torch.data.loader import BatchLoader
from cl_object_detection_tpu_torch.il import herding, losses as tlosses, prototype
from cl_object_detection_tpu_torch.il.pseudo_label import generate_pseudo_labels
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables, port_name
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet, unfold3x3
from cl_object_detection_tpu_torch.states import ILStates
from cl_object_detection_tpu_torch.train.loop import train_process
from cl_object_detection_tpu_torch.train.trainer import ILTrainer
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

torch.set_num_threads(1)

CFG = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
C_OLD, C_NEW = 3, 2
C = C_OLD + C_NEW
H = W = 128
ANCHORS = anchors_for_shape(H, W)
SIM = np.array([[0.6, 0.3, 0.1], [0.2, 0.5, 0.3]], np.float32)
LR = 1e-5
HERD_RATIO = 0.05


# ----------------------------------------------------------------- helpers

def np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def randomize(variables, seed, cls_bias):
    """Random BN statistics and affines; random output convs, the
    classification bias around ``cls_bias``."""
    r = np.random.RandomState(seed)

    def leaf(path, x):
        keys = tuple(p.key for p in path)
        x = np.asarray(x)
        if keys[-2:-1] == ("bn",):
            if keys[-1] == "mean":
                return (r.randn(*x.shape) * 0.1).astype(np.float32)
            if keys[-1] == "var":
                return (np.abs(r.randn(*x.shape)) * 0.2 + 0.8).astype(np.float32)
            if keys[-1] == "scale":
                return (1 + r.randn(*x.shape) * 0.1).astype(np.float32)
            return (r.randn(*x.shape) * 0.05).astype(np.float32)
        if "output" in keys:
            if keys[-1] == "kernel":
                return (r.randn(*x.shape) * 0.01).astype(np.float32)
            base = cls_bias if "classification_head" in keys else 0.0
            return (base + r.randn(*x.shape) * 0.3).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@functools.lru_cache(maxsize=None)
def jax_model(num_classes, seed, cls_bias=-1.5):
    """A JAX model and its randomized variables at ``num_classes``."""
    model = j_create(jcfg.ModelConfig(**CFG), num_classes)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))
    return model, np_tree(randomize(v, 100 + seed, cls_bias))


def to_port(params) -> dict:
    """A JAX ``params``-shaped tree as {port name: float32 numpy, OIHW}."""
    out = {}
    for path, val in jax.tree_util.tree_leaves_with_path(params):
        arr = np.asarray(val, np.float32)
        name = port_name(("params",) + tuple(p.key for p in path))
        out[name] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    return out


def assert_grads_close(got: dict, want: dict):
    """The train step's gradient bar (tests/test_torch_train_step.py):
    |d| <= 1e-3 |g_jax| + 1e-4 max|g_jax|, leaf by leaf."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for name, w in want.items():
        bad = np.abs(got[name] - w) > 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()
        assert not bad.any(), (f"grad {name}: {int(bad.sum())} of {w.size} beyond tolerance, "
                               f"max |d| {np.abs(got[name] - w).max():.3g}, "
                               f"max |g| {np.abs(w).max():.3g}")


def port_model(variables, num_classes):
    model = create_retinanet(tcfg.ModelConfig(**CFG), num_classes, device="cpu")
    load_jax_variables(model, variables)
    return model


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def frames(seed, n=2):
    r = np.random.RandomState(seed)
    img = r.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    return ((img.astype(np.float32) / 255.0 - 0.45) / 0.225).astype(np.float32)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """12 PNG images at 96 x 96, 5 classes; the first 10 hold one box of
    class ``idx % 5`` each."""
    root = str(tmp_path_factory.mktemp("toy_replay"))
    json_path = make_toy_dataset(root, num_images=12, image_size=(96, 96), seed=5)
    return json_path, os.path.join(root, "images")


@pytest.fixture
def run_dir(tmp_path):
    """``tmp_path``, emptied after the test: a 2-state run writes ~270 MB
    of R18 checkpoints (parameters and Adam moments)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


DATA = dict(batch_size=2, min_side=96, max_side=96, height=H, width=W, max_boxes=8,
            num_workers=0, prefetch=0)


def datasets(toy, state):
    """The JAX and the port ILDataset of ``state``'s training images
    (scenario 3+2)."""
    json_path, images = toy
    out = []
    for coco_cls, states_cls, ds_cls in ((JCocoJson, JILStates, JILDataset),
                                         (CocoJson, ILStates, ILDataset)):
        coco = coco_cls(json_path)
        states = states_cls(list(coco.classes.values()), coco.classes_inverse, ["3", "2"])
        out.append(ds_cls(coco, states, images, split="train", start_state=state))
    return out


# ------------------------------------------- unfold, classification_features

def test_unfold3x3_matches_jax_bit_for_bit():
    x = np.random.RandomState(0).randn(2, 5, 7, 6).astype(np.float32)
    want = np.asarray(j_unfold3x3(jnp.asarray(x)))
    got = unfold3x3(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (2, 35, 54)
    np.testing.assert_array_equal(got.numpy(), want)


def test_classification_features_matches_jax():
    model, v = jax_model(C, 1)
    x = frames(3)
    jcls, jreg, jfeats, junf = jax.jit(lambda vv, xx: model.apply(
        vv, xx, enable_act=False, method="classification_features"))(v, jnp.asarray(x))
    with torch.no_grad():
        cls, reg, feats, unf = port_model(v, C).classification_features(
            torch.from_numpy(x), False)
    assert unf.shape == (2, sum((H // s) * (W // s) for s in (8, 16, 32, 64, 128)), 32 * 9)
    for got, want in [(cls, jcls), (reg, jreg)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    # the FPN maps and the trunk's pre-ReLU values reach ~30 here: atol
    # scales with them
    for got, want in [(unf.numpy(), junf)] + [(nhwc(f), jf) for f, jf in zip(feats, jfeats)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())


# ----------------------------------------------------------------- herding

def test_foreground_ratio_matches_jax_exactly():
    r = np.random.RandomState(4)
    for _ in range(20):
        n = r.randint(1, 7)
        xy = r.uniform(0, 80, (n, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + r.uniform(5, 60, (n, 2)).astype(np.float32)], 1)
        labels = r.randint(-1, 3, n).astype(np.int32)
        assert herding.foreground_ratio(boxes, labels, 96.0 * 128) == \
            jherding.foreground_ratio(boxes, labels, 96.0 * 128)
    # two overlapping boxes of one class: the sum of the areas less the overlap
    boxes = np.array([[0, 0, 10, 10], [5, 5, 15, 15]], np.float32)
    assert herding.foreground_ratio(boxes, np.array([0, 0]), 1000.0) == {0: 175 / 1000.0}


@pytest.mark.parametrize("h,w,size", [(16, 16, 132), (80, 128, 132), (5, 8, 9), (1, 1, 9),
                                      (140, 200, 132), (300, 160, 66), (10, 4, 9)])
def test_resize_bilinear_matches_jax_image_resize(h, w, size):
    """Growing (P3..P7 of the frames in use) and shrinking (a P3 above
    132, frames above 1056 pixels) against ``jax.image.resize``, and
    against the float64 product of JAX's own weight matrices."""
    from jax._src.image.scale import ResizeMethod, _kernels, compute_weight_mat

    for n, o in ((h, size), (w, size)):
        if n != o:
            want_w = np.asarray(compute_weight_mat(n, o, o / n, 0.0,
                                                   _kernels[ResizeMethod.LINEAR], True))
            np.testing.assert_allclose(herding.resize_weights(n, o), want_w.T, rtol=1e-6,
                                       atol=1e-7)
    x = np.random.RandomState(h * w).randn(2, h, w, 3).astype(np.float32)
    got = nhwc(herding.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size, size))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(x).max())
    wh = herding.resize_weights(h, size).astype(np.float64) if h != size else np.eye(h)
    ww = herding.resize_weights(w, size).astype(np.float64) if w != size else np.eye(w)
    exact = np.einsum("bhwc,Hh,Ww->bHWc", x.astype(np.float64), wh, ww, optimize=True)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-6 * np.abs(x).max())


def test_herding_feature_vector_matches_jax():
    model, v = jax_model(C_OLD, 0)
    x = frames(5)
    want = np.asarray(jherding.make_feature_fn(model)(v, jnp.asarray(x)))
    got = herding.make_feature_fn(port_model(v, C_OLD))(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, sum(s * s for s in herding.FEATURE_SIZES) * 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_herd_sampler_picks_equal_jax(toy):
    """Herding over the state-0 images with the state-1 images excluded:
    the same exemplars as JAX's, 2 per old class, in the same order; a
    second call (as at a later state) reuses no image."""
    model, v = jax_model(C_OLD, 0)
    jds, pds = datasets(toy, 0)
    future = jds.coco.get_imgs_by_cats(jds.states[1].new_ids)
    js = jherding.HerdSampler(model, HERD_RATIO)
    want = js.sample(v, jds, jcfg.DataConfig(**DATA), 2, future_img_ids=future)
    ps = herding.HerdSampler(HERD_RATIO)
    got = ps.sample(port_model(v, C_OLD), pds, tcfg.DataConfig(**DATA), 2,
                    future_img_ids=future)
    assert got == want and ps.examplar_list == js.examplar_list
    assert sorted(got) == [0, 1, 2] and all(len(ids) == 2 for ids in got.values())
    assert not set(ps.examplar_list) & set(future)
    again = ps.sample(port_model(v, C_OLD), pds, tcfg.DataConfig(**DATA), 2,
                      future_img_ids=future)
    assert not {i for ids in again.values() for i in ids} & {i for ids in got.values()
                                                             for i in ids}


# -------------------------------------------------------------- prototypes

def test_compute_prototype_features_matches_jax(toy):
    model, v = jax_model(C_OLD, 0)
    jds, pds = datasets(toy, 0)
    want = jproto.compute_prototype_features(
        model, v, lambda images: ANCHORS, JBatchLoader(jds, jcfg.DataConfig(**DATA),
                                                      shuffle=False, augment=False), C_OLD)
    got = prototype.compute_prototype_features(
        port_model(v, C_OLD), ANCHORS, BatchLoader(pds, tcfg.DataConfig(**DATA),
                                                   shuffle=False, augment=False), C_OLD)
    assert got.shape == want.shape == (C_OLD, 9, 32 * 9) and got.dtype == np.float32
    assert (np.abs(want).sum(axis=2) > 0).sum() >= C_OLD
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _proto_loss_inputs(seed):
    r = np.random.RandomState(seed)
    b, cells, d = 2, 12, 16
    unfolded = r.randn(b, cells, d).astype(np.float32)
    pos = r.rand(b, cells * 9) < 0.3
    labels = r.randint(-1, C, (b, cells * 9)).astype(np.int32)
    old = (r.randn(C_OLD, d) * 2).astype(np.float32)
    return unfolded, pos, labels, old


@pytest.mark.parametrize("margin", [600.0, 6.0])
def test_prototype_loss_value_and_grad_match_jax(margin):
    unfolded, pos, labels, old = _proto_loss_inputs(6)
    kw = dict(num_past_class=C_OLD, num_new_class=C_NEW, margin=margin, weight=0.1)
    want, want_g = jax.value_and_grad(
        lambda u: jproto.prototype_loss_from_batch(u, jnp.asarray(pos), jnp.asarray(labels),
                                                   jnp.asarray(old), **kw))(
        jnp.asarray(unfolded))
    u = torch.from_numpy(unfolded).requires_grad_(True)
    got = prototype.prototype_loss_from_batch(u, torch.from_numpy(pos),
                                              torch.from_numpy(labels),
                                              torch.from_numpy(old), **kw)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want_g)).max())


def test_prototype_loss_margin():
    """JAX's tests/test_il_methods.py case: inside the margin the loss is
    positive; far outside it, 0."""
    b, cells, d = 1, 4, 8
    unfolded = torch.ones((b, cells, d))
    pos = torch.zeros((b, cells * 9), dtype=torch.bool)
    pos[0, 0] = True
    labels = torch.zeros((b, cells * 9), dtype=torch.int32) + 2
    old = torch.zeros((2, d))
    kw = dict(num_past_class=2, num_new_class=1, margin=10.0, weight=1.0)
    assert float(prototype.prototype_loss_from_batch(unfolded, pos, labels, old, **kw)) > 0
    far = prototype.prototype_loss_from_batch(unfolded * 1000, pos, labels, old, **kw)
    assert float(far) == 0.0


def test_sample_by_slot_scores_reference_semantics():
    """JAX's hand-computed fixture: the budget split round-robin over slot
    ranks (count-descending), each rank closest-first from its slot,
    taken and excluded images skipped; equal to JAX's on the same data."""
    counts = np.array([[5.0, 9.0, 1.0], [2.0, 1.0, 3.0]])
    scores = {
        0: {0: {10: 0.3, 11: 0.1}, 1: {12: 0.5, 13: 0.2, 10: 0.4}, 2: {14: 0.9}},
        1: {0: {20: 0.1}, 1: {}, 2: {21: 0.2, 12: 0.1}},
    }
    out = prototype.sample_by_slot_scores(scores, counts, per_num=4, classes=[0, 1],
                                          num_anchors=3)
    assert out == {0: [13, 10, 11, 14], 1: [12, 21, 20]}
    out2 = prototype.sample_by_slot_scores(scores, counts, per_num=4, classes=[0],
                                           already=[13], exclude={14}, num_anchors=3)
    assert out2 == {0: [10, 12, 11]}
    for kw in (dict(classes=[0, 1]), dict(classes=[0], already=[13], exclude={14})):
        assert prototype.sample_by_slot_scores(scores, counts, 4, num_anchors=3, **kw) == \
            jproto.sample_by_slot_scores(scores, counts, 4, num_anchors=3, **kw)
    imgs = {100: 0.4, 101: 0.1, 102: 0.3}
    assert prototype.sample_by_slot_scores({0: {0: dict(imgs)}}, np.array([[3.0]]), 2,
                                           classes=[0], num_anchors=1)[0] == \
        prototype.sample_by_scores({0: dict(imgs)}, 2)[0] == [101, 102]


@pytest.mark.parametrize("mode", ["slots", "classmean"])
def test_prototype_herd_picks_equal_jax(toy, mode):
    """Both prototype-herd modes over the state-0 images against the
    state-0 prototypes: the scores at rtol 1e-4, the picks equal JAX's."""
    model, v = jax_model(C_OLD, 0)
    jds, pds = datasets(toy, 0)
    jd, pd = jcfg.DataConfig(**DATA), tcfg.DataConfig(**DATA)
    protos = jproto.compute_prototype_features(
        model, v, lambda images: ANCHORS,
        JBatchLoader(jds, jd, shuffle=False, augment=False), C_OLD)
    pm = port_model(v, C_OLD)
    future = set(jds.coco.get_imgs_by_cats(jds.states[1].new_ids))
    if mode == "slots":
        jscores, jcounts = jproto.prototype_herd_slot_scores(
            model, v, lambda images: ANCHORS, jds, jd, protos)
        scores, counts = prototype.prototype_herd_slot_scores(pm, ANCHORS, pds, pd, protos)
        np.testing.assert_array_equal(counts, jcounts)
        flat = [(c, s, i) for c in jscores for s in jscores[c] for i in jscores[c][s]]
        assert flat == [(c, s, i) for c in scores for s in scores[c] for i in scores[c][s]]
        want_s = np.asarray([jscores[c][s][i] for c, s, i in flat])
        np.testing.assert_allclose([scores[c][s][i] for c, s, i in flat], want_s, rtol=1e-4,
                                   atol=1e-4 * want_s.max())
        kw = dict(classes=range(C_OLD), exclude=future, num_anchors=9)
        want = jproto.sample_by_slot_scores(jscores, jcounts, 2, **kw)
        got = prototype.sample_by_slot_scores(scores, counts, 2, **kw)
    else:
        jscores = jproto.prototype_herd_scores(model, v, lambda images: ANCHORS, jds, jd, protos)
        scores = prototype.prototype_herd_scores(pm, ANCHORS, pds, pd, protos)
        assert {c: sorted(d) for c, d in scores.items()} == \
            {c: sorted(d) for c, d in jscores.items()}
        flat = [(c, i) for c in jscores for i in jscores[c]]
        want_s = np.asarray([jscores[c][i] for c, i in flat])
        np.testing.assert_allclose([scores[c][i] for c, i in flat], want_s, rtol=1e-4,
                                   atol=1e-4 * want_s.max())
        keep = lambda s: {c: {i: x for i, x in d.items() if i not in future}  # noqa: E731
                          for c, d in s.items()}
        want = jproto.sample_by_scores(keep(jscores), 2)
        got = prototype.sample_by_scores(keep(scores), 2)
    assert got == want and sum(len(ids) for ids in got.values()) >= C_OLD


# ----------------------------------------------------------- pseudo-labels

def test_generate_pseudo_labels_matches_jax(toy):
    """A teacher whose classification bias is raised (so it detects)
    pseudo-labels the state-1 images: the same images, counts, classes,
    boxes and scores as JAX's; every kept box clears the real GT."""
    model, v = jax_model(C_OLD, 2, cls_bias=1.0)
    jds, pds = datasets(toy, 1)
    pcfg = dict(enabled=True, score_thresh=0.7, iou_thresh=0.35, max_labels_per_image=5)
    want = j_pseudo(model, v, jds, jcfg.DataConfig(**DATA), jcfg.PseudoLabelConfig(**pcfg),
                    jds.states.inverse_label_map())
    got = generate_pseudo_labels(port_model(v, C_OLD), pds, tcfg.DataConfig(**DATA),
                                 tcfg.PseudoLabelConfig(**pcfg), pds.states.inverse_label_map())
    assert list(got) == list(want) == list(pds.image_ids)
    assert [len(a) for a in got.values()] == [len(a) for a in want.values()]
    assert sum(len(a) for a in got.values()) > 0
    for img_id, anns in want.items():
        for g, w in zip(got[img_id], anns):
            assert g["category_id"] == w["category_id"] and g["category_id"] <= C_OLD
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=1e-4)
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4)
            assert g["score"] > 0.7


# --------------------------------------------------------- the loss term

def test_compute_losses_prototype_and_pseudo_progress_match_jax():
    """The incremental path with the prototype term and the pseudo-label
    progress: every metric at rtol 1e-4 against JAX's, and the prototype
    term's gradient, parameter by parameter, at the train step's bar
    against JAX's jitted value_and_grad of that term. (The total's
    gradient on this batch parts from JAX's in the regression head's
    trunk, beyond the bar by up to 4.6x, with or without the prototype
    and pseudo-label terms: a pre-activation that rounding puts on either
    side of a ReLU's kink, ROADMAP §3.)"""
    model, v = jax_model(C, 1)
    x = frames(8)
    r = np.random.RandomState(8)
    boxes = np.full((2, 5, 4), -1, np.float32)
    labels = np.full((2, 5), -1, np.int32)
    for b in range(2):
        for j, lab in enumerate((C_OLD, C_OLD + 1, 0)):
            x1, y1 = r.uniform(0, 60, 2)
            boxes[b, j] = [x1, y1, x1 + r.uniform(30, 64), y1 + r.uniform(30, 64)]
            labels[b, j] = lab
    protos = (r.randn(C_OLD, 32 * 9) * 0.5).astype(np.float32)
    il = dataclasses.replace(jcfg.ILConfig(), prototype=jcfg.PrototypeConfig(loss=True))
    statics = dict(num_classes=C, num_past_class=C_OLD, incremental=True, use_prototype=True,
                   use_pseudo_progress=True)
    from cl_object_detection_tpu.il import losses as jlosses

    def loss_fn(params):
        _, m = jlosses.compute_losses(
            lambda vv, xx, act: model.apply(vv, xx, enable_act=act),
            lambda vv, xx, act: model.apply(vv, xx, enable_act=act, method="forward_all"),
            {"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(ANCHORS), il,
            jcfg.FocalConfig(), jlosses.LossStatics(**statics),
            pseudo_progress=jnp.asarray(0.5, jnp.float32),
            prototype_extras={"apply": lambda vv, xx: model.apply(
                vv, xx, enable_act=False, method="classification_features"),
                "old_prototypes": jnp.asarray(protos), "margin": 600.0, "weight": 0.1})
        return m["prototype_loss"], m

    (_, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    pm = port_model(v, C)
    total, metrics = tlosses.compute_losses(
        pm, torch.from_numpy(x), torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(ANCHORS), tcfg.ILConfig(prototype=tcfg.PrototypeConfig(loss=True)),
        tcfg.FocalConfig(), tlosses.LossStatics(**statics),
        pseudo_progress=torch.tensor(0.5), prototype_features=torch.from_numpy(protos))
    metrics["prototype_loss"].backward()
    assert set(metrics) == set(jm) and "prototype_loss" in metrics
    assert float(metrics["prototype_loss"].detach()) > 0
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    jgrads = to_port(jgrads)
    got = {n: p.grad.numpy() if p.grad is not None else np.zeros_like(jgrads[n])
           for n, p in pm.named_parameters()}
    assert_grads_close(got, jgrads)
    assert np.abs(got["classification_head.conv2.weight"]).max() > 0
    assert not np.abs(got["regression_head.conv1.weight"]).any()


# ------------------------------------------------------------ the trainer

def jax_cfg(ckpt_dir, **il):
    return jcfg.TrainConfig(
        model=jcfg.ModelConfig(**CFG), data=jcfg.DataConfig(**DATA),
        schedule=jcfg.ScheduleConfig(lr=LR, every_iter=1, new_state_epoch=1),
        il=jcfg.ILConfig(scenario=("3", "2"), end_state=1, init_method="mean", **il),
        checkpoint_dir=ckpt_dir, start_epoch=1, end_epoch=1, save_every=1, record=False,
    )


REPLAY_IL = dict(
    distill=jcfg.DistillConfig(enabled=True),
    replay=jcfg.ReplayConfig(sample_num=2, sample_method="herd", sample_batch_size=2,
                             mix_data=True, enhance_error=True,
                             herd_ratio_threshold=HERD_RATIO),
    final_correction=True,
    pseudo=jcfg.PseudoLabelConfig(enabled=True),
    prototype=jcfg.PrototypeConfig(loss=True, start_epoch=0),
)


def port_cfg(jc, **changes) -> tcfg.TrainConfig:
    return tcfg.TrainConfig.from_json(jc.to_json()).replace(**changes)


def _spy_run_batch(trainer, log: list):
    """Record (state, is_replay, correction, metric keys, total_loss) of
    every micro-step."""
    orig = trainer.run_batch

    def run_batch(batch, is_replay=False, sync_metrics=True, correction=False):
        m = orig(batch, is_replay=is_replay, sync_metrics=True, correction=correction)
        log.append((trainer.cur_state, is_replay, correction, sorted(m), m["total_loss"]))
        return m

    trainer.run_batch = run_batch


@pytest.fixture(scope="module")
def two_state(toy, tmp_path_factory):
    """JAX's and the port's trainers from the same initial weights through
    train_process: state 0, then state 1 with distillation, herd replay
    (2 per old class) interleaved by mix_data, enhance_error and the
    final correction, pseudo-labels and the prototype loss from epoch 1;
    the ``mean`` warm-start from a seeded similarity sidecar. From the
    initial weights (zero output kernels, the prior's bias) the teacher
    detects nothing and no new-class score passes enhance_error's 0.05:
    the runs stay off those thresholds, where parameters that Adam has
    moved apart by ~4e-5 in state 0 would pick other pseudo-labels or
    enhance entries (``test_replay_tools_with_a_detecting_teacher`` runs
    them busy, in the port alone; the functions are held to JAX above)."""
    json_path, images = toy
    tmp = tmp_path_factory.mktemp("two_state_replay")
    jc = jax_cfg(str(tmp / "jax" / "ckpt"), **REPLAY_IL)
    jt = JILTrainer(jc, json_path, images, workdir=str(tmp / "jax"))
    pt = ILTrainer(port_cfg(jc, checkpoint_dir=str(tmp / "port" / "ckpt")), json_path, images,
                   workdir=str(tmp / "port"), device="cpu")
    load_jax_variables(pt.model, jax.tree.map(np.asarray, jt.train_state.variables))
    pt._new_train_state()
    jt.ckpt.save_array_sidecar(0, "similarity", [SIM])
    pt.ckpt.save_array_sidecar(0, "similarity", {"[0]": SIM})
    steps: list = []
    _spy_run_batch(pt, steps)
    j_train_process(jt)
    train_process(pt)
    yield dict(jt=jt, pt=pt, jc=jc, tmp=tmp, steps=steps)
    shutil.rmtree(tmp, ignore_errors=True)


def _exemplars(trainer):
    return list(trainer.dataset_replay.image_ids)


def test_two_state_replay_train_process_matches_jax(two_state):
    """Every micro-step's total_loss (state 0, state 1, replay) at rtol
    1e-4 against JAX's; the same exemplars (a full set: 2 per old class,
    none holding a state-1 class) and pseudo-labels (one entry per new
    image); at state 1 the prototype and distillation terms in every
    new-image micro-step, ``enhance_loss`` in every replay one, replay
    interleaved into the epoch, and the final correction ended after one
    clean round."""
    jt, pt, steps = two_state["jt"], two_state["pt"], two_state["steps"]
    got, want = list(pt.loss_hist), list(jt.loss_hist)
    assert len(got) == len(want) and len(got) > pt.epoch_log[0]["micro_steps"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g)
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=f"micro-step {i}")
    ex = _exemplars(pt)
    assert ex == _exemplars(jt) == pt.herd_sampler.examplar_list == jt.herd_sampler.examplar_list
    assert len(ex) == 2 * C_OLD and len(set(ex)) == len(ex)
    assert not set(ex) & set(pt.coco.get_imgs_by_cats(pt.states[1].new_ids))
    assert pt.dataset_train.pseudo_labels == jt.dataset_train.pseudo_labels
    assert set(pt.dataset_train.pseudo_labels) == set(pt.dataset_train.image_ids)
    state1 = [s for s in steps if s[0] == 1 and not s[2]]
    new = [keys for _, replay, _, keys, _ in state1 if not replay]
    replay = [keys for _, r, _, keys, _ in state1 if r]
    assert new and replay
    assert all({"prototype_loss", "dist_feat_loss", "dist_cls_loss"} <= set(k) for k in new)
    assert all("enhance_loss" in k for k in replay)
    order = [r for _, r, _, _, _ in state1]
    assert order.index(True) < len(order) - order[::-1].index(False) - 1  # interleaved
    corrections = [s for s in steps if s[2]]
    assert len(corrections) == len(pt.replay_loader)
    assert all(s[3] == ["enhance_loss", "total_loss"] for s in corrections)
    assert np.isfinite([s[4] for s in steps]).all()


def test_state1_checkpoint_exemplar_ids_equal_jax(two_state):
    """The state-1 checkpoint's ``exemplar_ids`` (state 0's: none) and the
    ``examplar`` sidecar and ``examplar.txt`` equal JAX's; JAX's
    ``prototype_features`` sidecar of state 0 equals the port's
    prototypes of JAX's state-0 checkpoint at the prototype bar (the two
    runs' state-0 models differ by Adam's rounding), and the port's
    sidecar holds the trainer's prototypes under the same key."""
    import json

    jt, pt = two_state["jt"], two_state["pt"]
    with open(os.path.join(jt.ckpt.epoch_dir(1, 1), "il_meta.json")) as f:
        jmeta = json.load(f)
    meta = pt.ckpt.restore(1, 1)[1]
    assert meta["exemplar_ids"] == jmeta["exemplar_ids"] == _exemplars(pt)
    assert pt.ckpt.restore(0, 1)[1]["exemplar_ids"] == []
    assert pt.ckpt.load_sidecar(1, "examplar") == jt.ckpt.load_sidecar(1, "examplar")
    for tr in (pt, jt):
        with open(os.path.join(tr.ckpt.state_dir(1), "examplar.txt")) as f:
            assert [int(x) for x in f.read().split()] == _exemplars(pt)
    got = pt.ckpt.load_array_sidecar(0, "prototype_features")
    want = jt.ckpt.load_array_sidecar(0, "prototype_features")
    assert list(got) == list(want) == ["[0]"]
    np.testing.assert_array_equal(got["[0]"], pt.prototype_features)
    tree, _ = jt.ckpt.restore(0, 1)
    jax_state0 = port_model({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                            C_OLD)
    again = prototype.compute_prototype_features(
        jax_state0, pt.anchors_for, BatchLoader(pt._prev_state_dataset(0), pt.cfg.data,
                                                shuffle=False, augment=False), C_OLD)
    np.testing.assert_allclose(again, want["[0]"], rtol=1e-4,
                               atol=1e-5 * np.abs(want["[0]"]).max())


def test_cross_state_entry_with_replay_equals_next_state(two_state, toy):
    """``start_state=1`` in a fresh run directory holding only the state-0
    checkpoint and its similarity sidecar: the prototypes, the exemplars
    (herding before the expansion, with the state-0 model: the same FPN)
    and the pseudo-labels are made anew and equal ``next_state``'s, and
    the state-1 losses equal the unbroken run's bit for bit."""
    json_path, images = toy
    pt = two_state["pt"]
    tmp = two_state["tmp"] / "entry"
    dst = tmp / "ckpt" / "3_2" / "state0"
    shutil.copytree(os.path.join(pt.ckpt.state_dir(0), "epoch1"), dst / "epoch1")
    shutil.copy(os.path.join(pt.ckpt.state_dir(0), "similarity.npz"), dst / "similarity.npz")
    cfg = port_cfg(two_state["jc"], checkpoint_dir=str(tmp / "ckpt"))
    cfg = cfg.replace(il=dataclasses.replace(cfg.il, start_state=1))
    tr = ILTrainer(cfg, json_path, images, workdir=str(tmp), device="cpu")
    assert tr.cur_state == 1 and tr.num_classes == C
    assert _exemplars(tr) == _exemplars(pt)
    assert tr.dataset_train.pseudo_labels == pt.dataset_train.pseudo_labels
    np.testing.assert_array_equal(tr.prototype_features, pt.prototype_features)
    train_process(tr)
    n0 = pt.epoch_log[0]["micro_steps"]
    assert list(tr.loss_hist) == list(pt.loss_hist)[n0:]
    assert tr.ckpt.restore(1, 1)[1]["exemplar_ids"] == _exemplars(pt)


def _small_run(toy, tmp, **il):
    json_path, images = toy
    cfg = port_cfg(jax_cfg(str(tmp / "ckpt"), **il))
    tr = ILTrainer(cfg, json_path, images, workdir=str(tmp), device="cpu")
    steps: list = []
    _spy_run_batch(tr, steps)
    train_process(tr)
    return tr, steps


def test_prototype_loss_without_replay(toy, run_dir):
    """JAX's tests/test_multistate.py case: ``prototype.loss`` with
    ``sample_num`` 0 still builds the prototypes at ``next_state``; they
    describe the previous state's 3 classes, and every state-1 micro-step
    carries the prototype term."""
    tr, steps = _small_run(toy, run_dir, distill=jcfg.DistillConfig(enabled=True),
                           prototype=jcfg.PrototypeConfig(loss=True, start_epoch=0))
    assert tr.cur_state == 1 and tr.dataset_replay is None
    assert tr.prototype_features is not None and tr.prototype_features.shape[0] == C_OLD
    state1 = [keys for st, _, _, keys, _ in steps if st == 1]
    assert state1 and all("prototype_loss" in k for k in state1)


def test_pseudo_labels_without_distill_or_mas(toy, run_dir):
    """JAX's tests/test_multistate.py case: pseudo-labels alone still build
    the frozen teacher (distillation off), and the dataset carries its
    labels; the state-1 steps run no distillation term."""
    tr, steps = _small_run(toy, run_dir,
                           pseudo=jcfg.PseudoLabelConfig(enabled=True, score_thresh=0.2))
    assert tr.cur_state == 1 and tr.teacher_model is not None
    assert tr.dataset_train.pseudo_labels is not None
    assert set(tr.dataset_train.pseudo_labels) == set(tr.dataset_train.image_ids)
    state1 = [keys for st, _, _, keys, _ in steps if st == 1]
    assert state1 and not any("dist_feat_loss" in k for k in state1)


@pytest.mark.parametrize("method,mode", [("prototype_herd", "slots"),
                                         ("prototype_herd", "classmean"), ("random", None)])
def test_other_selectors_fill_the_replay_set(toy, run_dir, method, mode):
    """prototype-herd (both modes) and random replay through the trainer:
    exemplars of the old classes only, none holding a state-1 class, in
    the checkpoint and the sidecar; replay micro-steps ran."""
    replay = jcfg.ReplayConfig(sample_num=2, sample_method=method, sample_batch_size=2,
                               prototype_herd_mode=mode or "slots")
    tr, steps = _small_run(toy, run_dir, replay=replay)
    ex = _exemplars(tr)
    assert ex and len(set(ex)) == len(ex)
    assert not set(ex) & set(tr.coco.get_imgs_by_cats(tr.states[1].new_ids))
    assert tr.ckpt.restore(1, 1)[1]["exemplar_ids"] == ex == tr.ckpt.load_sidecar(1, "examplar")
    if method == "prototype_herd":
        assert tr._proto_exemplars == ex and tr.prototype_features.shape[:2] == (C_OLD, 9)
    assert any(r for st, r, _, _, _ in steps if st == 1)


def test_replay_tools_with_a_detecting_teacher(toy, run_dir):
    """The port alone, from weights whose classification output is
    randomized around bias -1.5 (the state-0 model then detects): the
    pseudo-labels fill every new image up to ``max_labels_per_image``
    rows, of old classes only; replay micro-steps carry a nonzero
    ``enhance_loss``; the final correction takes one plain step per
    replay batch and ends within its 20 rounds; every loss is finite."""
    json_path, images = toy
    il = dict(REPLAY_IL, pseudo=jcfg.PseudoLabelConfig(enabled=True, score_thresh=0.2,
                                                       max_labels_per_image=4))
    cfg = port_cfg(jax_cfg(str(run_dir / "ckpt"), **il))
    tr = ILTrainer(cfg, json_path, images, workdir=str(run_dir), device="cpu")
    model, v = jax_model(C_OLD, 3)
    load_jax_variables(tr.model, v)
    tr._new_train_state()
    tr.ckpt.save_array_sidecar(0, "similarity", {"[0]": SIM})
    steps: list = []
    _spy_run_batch(tr, steps)
    train_process(tr)
    pseudo = tr.dataset_train.pseudo_labels
    assert set(pseudo) == set(tr.dataset_train.image_ids)
    assert sum(len(a) for a in pseudo.values()) > 0 and max(len(a) for a in pseudo.values()) <= 4
    assert {a["category_id"] for anns in pseudo.values() for a in anns} <= set(
        tr.states[0].new_ids)
    replay = [m for st, r, c, _, m in steps if st == 1 and r and not c]
    assert replay and all(np.isfinite(replay))
    corrections = [s for s in steps if s[2]]
    assert corrections and len(corrections) % len(tr.replay_loader) == 0
    assert len(corrections) <= 20 * len(tr.replay_loader)
    assert any(s[4] > 0 for s in corrections)
    assert np.isfinite([s[4] for s in steps]).all()
