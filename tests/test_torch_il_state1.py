"""The port's incremental state 1 against the JAX package's, in float32 on
the CPU: classifier expansion (``models/expand.py``), the similarity
warm-start (``il/weight_init.py``), SCAIL (``il/scail.py``), the
incremental half of ``il/losses.compute_losses`` and the trainer from
state 0 into state 1 (``train/trainer.py``, ``train/loop.py``,
``cli/train.py``). Weights cross from JAX through ``models.bridge``.
The item-4b flags (replay, its switches, the prototype loss and
pseudo-labels) run through ``cli.train`` into state 1 here; their
functions are held to JAX in tests/test_torch_il_replay.py.

Models: R18, FPN 32, 2 head layers, 3 old + 2 new classes, 128 x 128
frames (the trainer: 128 x 192).

Tolerances:
  * expansion, class vectors and SCAIL: bit for bit (both packages run
    the same float32 numpy operations in the same order);
  * the similarity matrix: within 1e-6 absolute, and nonzero (the old
    model's classification bias is raised so that the old-class gate
    passes);
  * loss values at rtol 1e-4 and gradients leaf by leaf at |d| <=
    1e-3 |g_jax| + 1e-4 max|g_jax|: the train step's bars
    (tests/test_torch_train_step.py), against JAX's jitted
    ``value_and_grad`` of ``compute_losses``, not its compiled step;
  * the fake-model distillation cases of tests/test_distill_loss.py: the
    numpy oracle at rtol 1e-5, as there;
  * the feature cosine and the classifier-similarity loss and its
    gradient: rtol 1e-5;
  * the trainer: every micro-step's total_loss at rtol 1e-4, lr 1e-5
    (tests/test_torch_trainer.py's bars); the cross-state entry and the
    mid-state resume against the port's unbroken run bit for bit.
"""
import dataclasses
import functools
import os
import shutil
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu.il import losses as jlosses
from cl_object_detection_tpu.il.scail import standardize_new_classifier as j_scail
from cl_object_detection_tpu.il.weight_init import compute_similarity as j_similarity
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.models.expand import classifier_class_vectors as j_class_vectors
from cl_object_detection_tpu.models.expand import expand_classifier as j_expand
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.train.loop import train_process as j_train_process
from cl_object_detection_tpu.train.trainer import ILTrainer as JILTrainer
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.cli.train import main as train_main
from cl_object_detection_tpu_torch.il import losses as tlosses
from cl_object_detection_tpu_torch.il.scail import ranked_mean
from cl_object_detection_tpu_torch.il.scail import standardize_new_classifier
from cl_object_detection_tpu_torch.il.weight_init import compute_similarity
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables, port_name
from cl_object_detection_tpu_torch.models.expand import (
    HEAD_BIAS,
    HEAD_WEIGHT,
    classifier_class_vectors,
    expand_classifier,
)
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.parallel.mesh import DataMesh
from cl_object_detection_tpu_torch.train import trainer as ttrainer
from cl_object_detection_tpu_torch.train.loop import train_process
from cl_object_detection_tpu_torch.train.optim import make_optimizer
from cl_object_detection_tpu_torch.train.state import TrainState
from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step
from cl_object_detection_tpu_torch.train.trainer import ILTrainer
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

torch.set_num_threads(1)

CFG = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
C_OLD, C_NEW = 3, 2
C = C_OLD + C_NEW
H = W = 128
ANCHORS = anchors_for_shape(H, W)
SIM = np.array([[0.6, 0.3, 0.1], [0.2, 0.5, 0.3]], np.float32)


# ----------------------------------------------------------------- helpers

def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def to_port(params) -> dict:
    """A JAX ``params``-shaped tree as {port name: float32 numpy, OIHW}."""
    out = {}
    for path, val in _leaves(jax.tree.map(np.asarray, params)):
        arr = np.asarray(val, np.float32)
        out[port_name(("params",) + path)] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    return out


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
    """A JAX model and its variables at ``num_classes``: initial weights
    from ``seed``, then randomized (the classification bias raised to
    ``cls_bias`` so that old-class probabilities pass the gates)."""
    model = j_create(jcfg.ModelConfig(**CFG), num_classes)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))
    return model, np_tree(randomize(v, 100 + seed, cls_bias))


def port_model(variables, num_classes):
    model = create_retinanet(tcfg.ModelConfig(**CFG), num_classes, device="cpu")
    load_jax_variables(model, variables)
    return model


class Batch(NamedTuple):
    images: np.ndarray
    boxes: np.ndarray
    labels: np.ndarray


def make_batch(seed, n=2):
    """RGB frames and GT of new and old classes (image 1 has no old one)."""
    r = np.random.RandomState(seed)
    img = r.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    x = ((img.astype(np.float32) / 255.0 - 0.45) / 0.225).astype(np.float32)
    boxes = np.full((n, 5, 4), -1, np.float32)
    labels = np.full((n, 5), -1, np.int32)
    for b in range(n):
        for j, lab in enumerate((C_OLD, C_OLD + 1, 0)[: 3 - b % 2]):
            x1, y1 = r.uniform(0, 60), r.uniform(0, 60)
            boxes[b, j] = [x1, y1, x1 + r.uniform(30, 64), y1 + r.uniform(30, 64)]
            labels[b, j] = lab
    return Batch(x, boxes, labels)


def targs(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)


def assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for name, w in want.items():
        g = got[name]
        bad = np.abs(g - w) > 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()
        assert not bad.any(), (f"grad {name}: {int(bad.sum())} of {w.size} beyond tolerance, "
                               f"max |d| {np.abs(g - w).max():.3g}, max |g| {np.abs(w).max():.3g}")


# ------------------------------------------------------- expansion, SCAIL

@pytest.mark.parametrize("method", ["mean", "large", "onlyNegative", "none"])
def test_expand_classifier_bit_equal_to_jax(method):
    """JAX's expansion of a JAX tree, carried into a port model at 5
    classes by ``load_jax_variables``, equals the port's expansion of the
    port model loaded from the unexpanded tree, bit for bit; old-class
    slots keep their values."""
    _, v = jax_model(C_OLD, 0)
    want = port_model(np_tree(j_expand(v, C_NEW, similarity=SIM, method=method,
                                       head_path="params/classification_head")), C)
    old = port_model(v, C_OLD)
    got = expand_classifier(old.state_dict(), C_NEW, similarity=SIM, method=method)
    model = create_retinanet(tcfg.ModelConfig(**CFG), C, device="cpu")
    model.load_state_dict(got)
    for name, t in want.state_dict().items():
        assert torch.equal(got[name], t), name
    w_old = old.state_dict()[HEAD_WEIGHT].reshape(9, C_OLD, -1)
    assert torch.equal(got[HEAD_WEIGHT].reshape(9, C, -1)[:, :C_OLD], w_old)
    new = got[HEAD_WEIGHT].reshape(9, C, -1)[:, C_OLD:]
    assert (float(new.abs().max()) > 0) == (method != "none")
    assert torch.equal(old.state_dict()[HEAD_WEIGHT], port_model(v, C_OLD).state_dict()[HEAD_WEIGHT])


def test_classifier_class_vectors_bit_equal_to_jax():
    """(C, A*kh*kw*cin) in JAX's order from the OIHW weight; a weight read
    as (C, A) class-major instead would give other rows."""
    _, v = jax_model(C_OLD, 0)
    sd = port_model(v, C_OLD).state_dict()
    want = j_class_vectors(v["params"])
    got = classifier_class_vectors(sd)
    assert got.shape == want.shape == (C_OLD, 9 * 3 * 3 * 32)
    assert np.array_equal(got, want)
    wrong = sd[HEAD_WEIGHT].numpy().reshape(C_OLD, 9, 32, 3, 3).transpose(0, 1, 3, 4, 2)
    assert not np.array_equal(wrong.reshape(C_OLD, -1), want)
    grad_form = tlosses.classifier_vectors(sd[HEAD_WEIGHT], 9)
    assert np.array_equal(grad_form.numpy(), want)


def test_scail_bit_equal_to_jax():
    """SCAIL after the ``mean`` expansion: equal to JAX's bit for bit, and
    every new class's filter norm equals the old classes' ranked-mean
    profile norm (tests/test_multistate.py's check, rtol 1e-5)."""
    _, v = jax_model(C_OLD, 0)
    jv = np_tree(j_expand(v["params"], C_NEW, similarity=SIM, method="mean"))
    want = to_port(j_scail(jv, C_OLD))
    got = standardize_new_classifier(
        expand_classifier(port_model(v, C_OLD).state_dict(), C_NEW, similarity=SIM), C_OLD)
    for name in (HEAD_WEIGHT, HEAD_BIAS):
        assert np.array_equal(got[name].numpy(), want[name]), name
    vecs = classifier_class_vectors(got)
    old_norm = float(np.linalg.norm(ranked_mean(vecs[:C_OLD])))
    assert old_norm > 1e-8
    for j in range(C_OLD, C):
        np.testing.assert_allclose(np.linalg.norm(vecs[j]), old_norm, rtol=1e-5)


# ------------------------------------------------------------- similarity

def test_compute_similarity_matches_jax():
    """Over three batches (two anchor grids: a callable provider), within
    1e-6 of JAX's, with nonzero entries for both new classes."""
    model, v = jax_model(C_OLD, 0)
    batches = [make_batch(s) for s in (1, 2, 3)]
    want = j_similarity(model, v, lambda images: jnp.asarray(ANCHORS), batches, C_NEW, C_OLD)
    got = compute_similarity(port_model(v, C_OLD), lambda images: ANCHORS, batches, C_NEW, C_OLD)
    assert got.dtype == np.float32 and got.shape == (C_NEW, C_OLD)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    assert (got.sum(axis=1) > 0).all() and abs(got.sum() - 1) < 1e-5
    # the mesh (ROADMAP §1 item 6a, once refused here): a one-rank mesh
    # gives one process's matrix
    one = DataMesh(rank=0, world=1, device=torch.device("cpu"))
    np.testing.assert_array_equal(
        compute_similarity(port_model(v, C_OLD), ANCHORS, batches, C_NEW, C_OLD, mesh=one), got)


# ------------------------------------------------ distillation, fake models
# tests/test_distill_loss.py's fixture and oracle, the port fed the
# feature maps NCHW

B, A = 2, 60


@pytest.fixture
def problem():
    rng = np.random.RandomState(0)
    anchors = np.zeros((A, 4), np.float32)
    cx, cy = rng.rand(A) * 200, rng.rand(A) * 200
    w = 20 + rng.rand(A) * 40
    anchors[:, 0], anchors[:, 1] = cx - w / 2, cy - w / 2
    anchors[:, 2], anchors[:, 3] = cx + w / 2, cy + w / 2
    boxes = np.full((B, 4, 4), -1, np.float32)
    labels = np.full((B, 4), -1, np.int32)
    boxes[:, 0] = anchors[5]
    labels[:, 0] = C_OLD
    logits = rng.randn(B, A, C).astype(np.float32)
    reg = rng.randn(B, A, 4).astype(np.float32) * 0.1
    t_logits = rng.randn(B, A, C_OLD).astype(np.float32)
    t_reg = rng.randn(B, A, 4).astype(np.float32) * 0.1
    feats = [rng.randn(B, 4, 4, 8).astype(np.float32) for _ in range(2)]
    t_feats = [rng.randn(B, 4, 4, 8).astype(np.float32) for _ in range(2)]
    return anchors, boxes, labels, logits, reg, t_logits, t_reg, feats, t_feats


class FakeModel:
    """``forward_all`` returning fixed outputs, feature maps NCHW."""

    def __init__(self, logits, reg, feats_nhwc):
        self.out = (torch.from_numpy(logits), torch.from_numpy(reg),
                    [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in feats_nhwc])

    def forward_all(self, images, enable_act):
        assert not enable_act
        return self.out


def _both(problem, ignore_gd, distill_logits=False):
    anchors, boxes, labels, logits, reg, t_logits, t_reg, feats, t_feats = problem
    kw = dict(num_classes=C, num_past_class=C_OLD, incremental=True, use_distill=True,
              distill_logits=distill_logits, ignore_gd=ignore_gd)
    _, want = jlosses.compute_losses(
        None, lambda v, x, act: (jnp.asarray(logits), jnp.asarray(reg), list(map(jnp.asarray, feats))),
        {"params": {}, "batch_stats": {}}, jnp.zeros((B, 8, 8, 3)), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(anchors), jcfg.ILConfig(), jcfg.FocalConfig(),
        jlosses.LossStatics(**kw),
        teacher_apply_with_feats=lambda v, x, act: (
            jnp.asarray(t_logits), jnp.asarray(t_reg), list(map(jnp.asarray, t_feats))),
        teacher_variables={})
    _, got = tlosses.compute_losses(
        FakeModel(logits, reg, feats), torch.zeros(B, 8, 8, 3), torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(anchors), tcfg.ILConfig(),
        tcfg.FocalConfig(), tlosses.LossStatics(**kw), teacher=FakeModel(t_logits, t_reg, t_feats))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    return got


def _oracle_masks(problem):
    anchors, boxes, labels, logits, reg, t_logits, t_reg, _, _ = problem
    t_prob = 1 / (1 + np.exp(-t_logits))
    t_fg = t_prob > 0.05
    bg_mask = np.ones((B, A), bool)
    for b in range(B):
        gt = boxes[b, 0]
        x1 = np.maximum(anchors[:, 0], gt[0]); y1 = np.maximum(anchors[:, 1], gt[1])
        x2 = np.minimum(anchors[:, 2], gt[2]); y2 = np.minimum(anchors[:, 3], gt[3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        a_area = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
        g_area = (gt[2] - gt[0]) * (gt[3] - gt[1])
        bg_mask[b] = inter / np.clip(a_area + g_area - inter, 1e-8, None) < 0.5
    return bg_mask & t_fg.any(axis=2), t_fg, t_prob


@pytest.mark.parametrize("ignore_gd,distill_logits", [(False, False), (True, False), (True, True)])
def test_distill_cls_mask_matches_jax_and_the_oracle(problem, ignore_gd, distill_logits):
    """Default: the teacher's foreground entries; ``ignore_gd``: every
    old-class column at the reg_mask anchors (teacher-bg entries too);
    on probabilities or logits. Every metric also equals JAX's."""
    got = _both(problem, ignore_gd, distill_logits)
    reg_mask, t_fg, t_prob = _oracle_masks(problem)
    _, _, _, logits, _, t_logits, _, _, _ = problem
    if distill_logits:
        sq = (t_logits - logits[:, :, :C_OLD]) ** 2
    else:
        sq = (t_prob - 1 / (1 + np.exp(-logits[:, :, :C_OLD]))) ** 2
    expected = sq[reg_mask].mean() if ignore_gd else sq[t_fg].mean()
    np.testing.assert_allclose(float(got["dist_cls_loss"]), expected, rtol=1e-5)
    if ignore_gd:
        assert reg_mask.sum() > 0 and t_fg[reg_mask].mean() < 1.0


def test_cosine_feat_loss_nchw_matches_jax(problem):
    """Over the NCHW maps' channel dim equals JAX's over NHWC maps; the
    same maps flattened with ``reshape(-1, C)`` (rows that mix channels
    and positions) give another value."""
    *_, feats, t_feats = problem
    want = float(jlosses._cosine_feat_loss([jnp.asarray(f) for f in feats],
                                           [jnp.asarray(f) for f in t_feats]))
    nchw = lambda fs: [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in fs]
    got = float(tlosses._cosine_feat_loss(nchw(feats), nchw(t_feats)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    wrong = 0.0
    for fs, ft in zip(nchw(feats), nchw(t_feats)):
        fs, ft = fs.reshape(-1, fs.shape[1]), ft.reshape(-1, ft.shape[1])
        wrong += float(torch.mean(1 - (fs * ft).sum(-1) / (fs.norm(dim=-1) * ft.norm(dim=-1))))
    assert abs(wrong - want) > 1e-3 * abs(want), (wrong, want)


def test_classifier_similarity_loss_and_gradient_match_jax():
    """Value and gradient with respect to the new-class vectors against
    JAX's ``value_and_grad``, at rtol 1e-5; some pairs pass the margin."""
    r = np.random.RandomState(5)
    past = r.randn(C_OLD, 64).astype(np.float32)
    new = (0.8 * past[[0, 2]] + 0.4 * r.randn(C_NEW, 64)).astype(np.float32)
    val, grad = jax.value_and_grad(jlosses.classifier_similarity_loss)(
        jnp.asarray(new), jnp.asarray(past), 0.5)
    w = torch.from_numpy(new).requires_grad_(True)
    got = tlosses.classifier_similarity_loss(w, torch.from_numpy(past), 0.5)
    got.backward()
    assert float(val) > 0
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-7)


# ------------------------------------- the incremental compute_losses grad

LOSS_CASES = {
    "distill_sim": dict(il=dict(), statics=dict(use_classifier_loss=True)),
    "logits_ignore_gd_flags": dict(
        il=dict(ignore_gd=True, new_ignore_past_class=True, decrease_positive=0.5,
                clip_loss=True, clip_cls_loss=0.05),
        statics=dict(distill_logits=True, ignore_gd=True, use_enhance_on_new=True)),
    "by_iou_ignore_past": dict(il=dict(decrease_positive_by_iou=True, ignore_past_class=True),
                               statics=dict(use_classifier_loss=True)),
}


@functools.lru_cache(maxsize=None)
def jax_incremental_loss_grad(case):
    model, _ = jax_model(C, 1)
    teacher, _ = jax_model(C_OLD, 0)
    il = dataclasses.replace(jcfg.ILConfig(), **LOSS_CASES[case]["il"])
    statics = jlosses.LossStatics(num_classes=C, num_past_class=C_OLD, incremental=True,
                                  use_distill=True, **LOSS_CASES[case]["statics"])

    def loss_fn(params, batch_stats, teacher_variables, images, boxes, labels, cvec):
        return jlosses.compute_losses(
            lambda vv, x, act: model.apply(vv, x, enable_act=act),
            lambda vv, x, act: model.apply(vv, x, enable_act=act, method="forward_all"),
            {"params": params, "batch_stats": batch_stats}, images, boxes, labels,
            jnp.asarray(ANCHORS), il, jcfg.FocalConfig(), statics,
            teacher_apply_with_feats=lambda vv, x, act: teacher.apply(
                vv, x, enable_act=act, method="forward_all"),
            teacher_variables=teacher_variables, classifier_vectors=cvec)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def student_variables():
    """The student at 5 classes: its own backbone, FPN and trunks, the
    classifier the ``mean`` expansion of the teacher's (so the new
    classes lie near the old ones and the similarity loss is nonzero)."""
    _, sv = jax_model(C, 1)
    _, tv = jax_model(C_OLD, 0)
    head = j_expand(tv["params"], C_NEW, similarity=SIM)["classification_head"]["output"]
    sv = jax.tree.map(lambda x: x, sv)
    sv["params"]["classification_head"]["output"] = np_tree(head)
    return sv


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_incremental_compute_losses_grad_matches_jax(case):
    """The incremental path with distillation from a teacher through the
    bridge: every metric at rtol 1e-4 and every parameter's gradient at
    the train step's bar against JAX's jitted value_and_grad; the
    teacher gets no gradient."""
    _, tv = jax_model(C_OLD, 0)
    sv = student_variables()
    batch = make_batch(7)
    cvec = j_class_vectors(tv["params"])
    (_, jmetrics), jgrads = jax_incremental_loss_grad(case)(
        sv["params"], sv["batch_stats"], tv, *(jnp.asarray(a) for a in batch), jnp.asarray(cvec))
    student, teacher = port_model(sv, C), port_model(tv, C_OLD).requires_grad_(False)
    il = dataclasses.replace(tcfg.ILConfig(), **LOSS_CASES[case]["il"])
    statics = tlosses.LossStatics(num_classes=C, num_past_class=C_OLD, incremental=True,
                                  use_distill=True, **LOSS_CASES[case]["statics"])
    total, metrics = tlosses.compute_losses(
        student, *targs(batch), torch.from_numpy(ANCHORS), il, tcfg.FocalConfig(), statics,
        teacher=teacher, classifier_vectors=torch.from_numpy(classifier_class_vectors(
            teacher.state_dict())))
    total.backward()
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("dist_feat_loss", "dist_reg_loss", "dist_cls_loss"):
        assert float(metrics[k].detach()) > 0, k
    if "sim_loss" in metrics:
        assert float(metrics["sim_loss"].detach()) > 0
    assert_grads_close({n: p.grad.numpy() for n, p in student.named_parameters()},
                       to_port(jgrads))
    assert all(p.grad is None for p in teacher.parameters())


def test_train_step_runs_the_teacher_under_no_grad_not_inference_mode():
    """make_train_step freezes the teacher; two micro-steps with an apply
    between them (a second backward after tensors the teacher's forward
    made) run, and the step passes the class vectors to the loss."""
    _, tv = jax_model(C_OLD, 0)
    student, teacher = port_model(student_variables(), C), port_model(tv, C_OLD)
    teacher.train()
    state = TrainState(student, make_optimizer(tcfg.ScheduleConfig(lr=1e-5), student))
    statics = tlosses.LossStatics(num_classes=C, num_past_class=C_OLD, incremental=True,
                                  use_distill=True, use_classifier_loss=True)
    step = make_train_step(student, teacher, ANCHORS, tcfg.ILConfig(), tcfg.FocalConfig(),
                           statics, StepStatics(every_iter=1, num_past_class=C_OLD,
                                                num_knowing_class=C))
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    cvec = torch.from_numpy(classifier_class_vectors(teacher.state_dict()))
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    for seed in (7, 8):
        state, metrics = step(state, *targs(make_batch(seed)), classifier_vectors=cvec)
        assert float(metrics["sim_loss"]) > 0 and np.isfinite(float(metrics["total_loss"]))
    assert state.step == 2
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("statics,key", [
    pytest.param(dict(use_mas=True), "mas_loss", id="statics2-item 4c"),
])
def test_unported_loss_terms_raise(statics, key):
    """The MAS penalty (ROADMAP §1 item 4c, once refused here) computes on
    the incremental path: finite and positive against previous
    parameters moved off the model's, 0 against the model's own."""
    _, v = jax_model(C_OLD, 0)
    model = port_model(v, C_OLD)
    params = dict(model.named_parameters())
    importance = {k: torch.ones_like(p) for k, p in params.items()}
    kw = dict(mas_importance=importance)
    for shift, positive in ((1e-3, True), (0.0, False)):
        prev = {k: p.detach() + shift for k, p in params.items()}
        _, metrics = tlosses.compute_losses(
            model, *targs(make_batch(1)), torch.from_numpy(ANCHORS),
            tcfg.ILConfig(mas=tcfg.MASConfig(enabled=True)), tcfg.FocalConfig(),
            tlosses.LossStatics(num_classes=C_OLD, incremental=True, **statics),
            mas_prev_params=prev, **kw)
        value = metrics[key].detach()
        assert torch.isfinite(value) and (float(value) > 0) == positive


@pytest.mark.parametrize("statics,key", [
    (dict(use_prototype=True), "prototype_loss"),
    (dict(use_pseudo_progress=True), "cls_bg_loss"),
])
def test_ported_4b_loss_terms_compute(statics, key):
    """The prototype term and the pseudo-label progress (ROADMAP §1 item
    4b, once refused here) compute: finite, with the prototype term
    positive against old prototypes at the origin (inside the margin),
    and the progress 0 discounting old-class entries of the pseudo-label
    anchors below their undiscounted loss."""
    _, v = jax_model(C, 1)
    model, batch = port_model(v, C), targs(make_batch(1))
    base = tlosses.LossStatics(num_classes=C, num_past_class=C_OLD, incremental=True)
    kw = dict(prototype_features=torch.zeros(C_OLD, 32 * 9),
              pseudo_progress=torch.tensor(0.0))
    il = tcfg.ILConfig(prototype=tcfg.PrototypeConfig(loss=True))
    with torch.no_grad():
        _, plain = tlosses.compute_losses(model, *batch, torch.from_numpy(ANCHORS), il,
                                          tcfg.FocalConfig(), base, **kw)
        _, got = tlosses.compute_losses(model, *batch, torch.from_numpy(ANCHORS), il,
                                        tcfg.FocalConfig(),
                                        dataclasses.replace(base, **statics), **kw)
    assert key in got and all(torch.isfinite(x) for x in got.values())
    if key == "prototype_loss":
        assert "prototype_loss" not in plain and float(got[key]) > 0
    else:
        assert float(got[key]) <= float(plain[key])


# ------------------------------------------------------------ the trainer

LR = 1e-5
TH, TW = 128, 192


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """10 PNG images at 96 x 160 (every third portrait), 5 classes; with
    min_side 96 and max_side 160 every image keeps its size (scale 1), so
    both packages' loaders give the same batches (tests/test_torch_data.py)."""
    root = str(tmp_path_factory.mktemp("toy_state1"))
    json_path = make_toy_dataset(root, num_images=10, image_size=(96, 160), seed=3)
    return json_path, os.path.join(root, "images")


def jax_cfg(ckpt_dir, **il):
    return jcfg.TrainConfig(
        model=jcfg.ModelConfig(depth=18, fpn_channels=32, head_layers=2,
                               compute_dtype="float32"),
        data=jcfg.DataConfig(batch_size=2, min_side=96, max_side=160, height=TH, width=TW,
                             max_boxes=8, num_workers=0, prefetch=0),
        schedule=jcfg.ScheduleConfig(lr=LR, every_iter=1, new_state_epoch=2),
        il=jcfg.ILConfig(scenario=("3", "2"), end_state=1, init_method="mean",
                         distill=jcfg.DistillConfig(enabled=True), classifier_loss=True, **il),
        checkpoint_dir=ckpt_dir, start_epoch=1, end_epoch=1, save_every=1, record=False,
    )


def port_cfg(jc, **changes) -> tcfg.TrainConfig:
    return tcfg.TrainConfig.from_json(jc.to_json()).replace(**changes)


def _capture_expansion(trainer, out: dict):
    orig = trainer.next_state

    def next_state():
        orig()
        out["expanded"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        out["teacher"] = {k: v.clone() for k, v in trainer.teacher_model.state_dict().items()}

    trainer.next_state = next_state


@pytest.fixture(scope="module")
def two_state(toy, tmp_path_factory):
    """JAX's and the port's trainers from the same initial weights through
    train_process: state 0 for one epoch, then state 1 for two, with
    distillation, the classifier-similarity loss and the ``mean``
    warm-start from the pre-seeded similarity sidecar."""
    json_path, images = toy
    tmp = tmp_path_factory.mktemp("two_state")
    jc = jax_cfg(str(tmp / "jax" / "ckpt"))
    jt = JILTrainer(jc, json_path, images, workdir=str(tmp / "jax"))
    pt = ILTrainer(port_cfg(jc, checkpoint_dir=str(tmp / "port" / "ckpt")), json_path, images,
                   workdir=str(tmp / "port"), device="cpu")
    load_jax_variables(pt.model, jax.tree.map(np.asarray, jt.train_state.variables))
    pt._new_train_state()
    # the similarity sidecar of state 0, seeded as the JAX SCAIL test
    # seeds it: an untrained model's similarity is all zeros (its
    # old-class gate never passes)
    jt.ckpt.save_array_sidecar(0, "similarity", [SIM])
    pt.ckpt.save_array_sidecar(0, "similarity", {"[0]": SIM})
    captured = {}
    _capture_expansion(pt, captured)
    j_train_process(jt)
    train_process(pt)
    yield dict(jt=jt, pt=pt, captured=captured, jc=jc, tmp=tmp)
    # ~1.1 GB of checkpoints (both packages', the entry's and the resume's)
    shutil.rmtree(tmp, ignore_errors=True)


def _state1_losses(trainer):
    return [r for r in trainer.epoch_log if r["state"] == 1]


def test_two_state_train_process_matches_jax(two_state):
    """Every micro-step's total_loss of both states at rtol 1e-4; the
    distillation and similarity terms present and finite at state 1; the
    state-1 head at 5 classes, whose old-class slots right after the
    expansion equal the state-0 checkpoint's bit for bit; the teacher is
    the state-0 checkpoint."""
    jt, pt, captured = two_state["jt"], two_state["pt"], two_state["captured"]
    got, want = list(pt.loss_hist), list(jt.loss_hist)
    n0 = pt.epoch_log[0]["micro_steps"]
    assert len(got) == len(want) and n0 > 0 and len(got) > n0
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g)
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=f"micro-step {i}")
    assert [(r["state"], r["epoch"]) for r in pt.epoch_log] == [(0, 1), (1, 1), (1, 2)]
    assert pt.ckpt.epochs(0) == [1] and pt.ckpt.epochs(1) == [1, 2]
    assert pt.num_classes == C and pt.model.classification_head.num_classes == C
    s0 = pt.ckpt.restore(0, 1)[0]["model"]
    s1, meta = pt.ckpt.restore(1, 2)
    assert s1["model"][HEAD_WEIGHT].shape[0] == 9 * C and meta["num_classes"] == C
    exp = captured["expanded"]
    assert torch.equal(exp[HEAD_WEIGHT].reshape(9, C, -1)[:, :C_OLD],
                       s0[HEAD_WEIGHT].reshape(9, C_OLD, -1))
    assert torch.equal(exp[HEAD_BIAS].reshape(9, C)[:, :C_OLD], s0[HEAD_BIAS].reshape(9, C_OLD))
    want_exp = expand_classifier(s0, C_NEW, similarity=SIM)
    assert all(torch.equal(exp[k], want_exp[k]) for k in want_exp)
    assert all(torch.equal(captured["teacher"][k], s0[k]) for k in s0)
    metrics = pt.run_batch(next(iter(pt.train_loader)))
    for k in ("dist_feat_loss", "dist_reg_loss", "dist_cls_loss", "sim_loss"):
        assert k in metrics and np.isfinite(metrics[k]), k


def test_cross_state_entry_equals_next_state(two_state, toy, monkeypatch):
    """``start_state=1`` in a fresh run directory holding only the state-0
    checkpoint and its similarity sidecar: the model is built at 3
    classes, restored and expanded to the weights ``next_state`` gave bit
    for bit (the sidecar read back: ``compute_similarity`` is never
    called), and its state-1 losses equal the unbroken run's, bit for
    bit, so JAX's at rtol 1e-4."""
    json_path, images = toy
    src, tmp = two_state["pt"].ckpt, two_state["tmp"] / "entry"
    dst = tmp / "ckpt" / "3_2" / "state0"
    shutil.copytree(os.path.join(src.state_dir(0), "epoch1"), dst / "epoch1")
    shutil.copy(os.path.join(src.state_dir(0), "similarity.npz"), dst / "similarity.npz")

    def no_similarity(*a, **k):
        raise AssertionError("the similarity sidecar was recomputed")

    monkeypatch.setattr(ttrainer, "compute_similarity", no_similarity)
    cfg = port_cfg(two_state["jc"], checkpoint_dir=str(tmp / "ckpt"), end_epoch=2).replace(
        il=dataclasses.replace(port_cfg(two_state["jc"]).il, start_state=1))
    tr = ILTrainer(cfg, json_path, images, workdir=str(tmp), device="cpu")
    assert tr.cur_state == 1 and tr.num_classes == C
    exp = two_state["captured"]["expanded"]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, exp[k]), k
    train_process(tr)
    n0 = two_state["pt"].epoch_log[0]["micro_steps"]
    assert list(tr.loss_hist) == list(two_state["pt"].loss_hist)[n0:]
    np.testing.assert_allclose(list(tr.loss_hist), list(two_state["jt"].loss_hist)[n0:],
                               rtol=1e-4)


def test_mid_state_resume_at_state1_is_bitwise(two_state, toy):
    """A fresh trainer at state 1, ``start_epoch=2``, over the unbroken
    run's checkpoints: built at 5 classes and restored (no expansion),
    the teacher from state 0; after ``resume(1, 1)`` and epoch 2 its
    parameters and loss window equal the unbroken run's bit for bit."""
    json_path, images = toy
    pt = two_state["pt"]
    tmp = two_state["tmp"] / "resume"
    shutil.copytree(pt.ckpt.scenario_dir, tmp / "ckpt" / "3_2")
    shutil.rmtree(tmp / "ckpt" / "3_2" / "state1" / "epoch2")
    cfg = port_cfg(two_state["jc"], checkpoint_dir=str(tmp / "ckpt"), start_epoch=2,
                   end_epoch=2).replace(
        il=dataclasses.replace(port_cfg(two_state["jc"]).il, start_state=1))
    tr = ILTrainer(cfg, json_path, images, workdir=str(tmp), device="cpu")
    assert tr.num_classes == C and tr.teacher_model is not None
    assert tr.resume(1, 1) == 1
    train_process(tr)
    want = pt.ckpt.restore(1, 2)[0]["model"]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert list(tr.loss_hist) == list(pt.loss_hist)


def test_similarity_sidecar_written_then_read_back(toy, tmp_path, monkeypatch):
    """Without a sidecar, entering state 1 computes the similarity with
    the state-0 model over the new state's unaugmented images, writes it
    under JAX's key, and a second entry reads it back."""
    json_path, images = toy
    jc = jax_cfg(str(tmp_path / "ckpt"))
    cfg = port_cfg(jc, checkpoint_dir=str(tmp_path / "ckpt"), end_epoch=1).replace(
        schedule=tcfg.ScheduleConfig(lr=LR, every_iter=1, new_state_epoch=1))
    calls = []
    real = ttrainer.compute_similarity

    def spy(model, anchors, loader, num_new, num_old, mesh=None):
        assert (loader.shuffle, loader.augment) == (False, False)
        assert model.classification_head.num_classes == C_OLD
        calls.append(real(model, anchors, loader, num_new, num_old))
        return calls[-1]

    monkeypatch.setattr(ttrainer, "compute_similarity", spy)
    tr = ILTrainer(cfg, json_path, images, workdir=str(tmp_path), device="cpu")
    train_process(tr)
    assert len(calls) == 1
    saved = tr.ckpt.load_array_sidecar(0, "similarity")
    assert list(saved) == ["[0]"] and np.array_equal(saved["[0]"], calls[0])
    entry = cfg.replace(il=dataclasses.replace(cfg.il, start_state=1))
    ILTrainer(entry, json_path, images, workdir=str(tmp_path), device="cpu")
    assert len(calls) == 1


# --------------------------------------------------------------- the CLI

CLI = ["--scenario", "3", "2", "--depth", "18", "--image_height", "128", "--image_width",
       "128", "--batch_size", "2", "--end_epoch", "1", "--new_state_epoch", "1",
       "--record", "false", "--print_il_info", "false", "--cpu"]


def _cli(toy, root, *extra):
    json_path, images = toy
    return ["--root_dir", root, "--train_json", json_path, "--image_dir", images, *CLI, *extra]


def test_train_cli_trains_state0_then_state1(toy, tmp_path):
    """``cli.train --start_state 0 --end_state 1 --distill true
    --classifier_loss true`` writes state-0 and state-1 checkpoints and
    the similarity sidecar; ``--start_state 1`` then enters state 1 from
    the state-0 checkpoint in the same run directory."""
    root = str(tmp_path)
    tr = train_main(_cli(toy, root, "--start_state", "0", "--end_state", "1",
                         "--distill", "true", "--classifier_loss", "true"))
    assert tr.ckpt.epochs(0) == [1] and tr.ckpt.epochs(1) == [1]
    assert os.path.exists(os.path.join(tr.ckpt.state_dir(0), "similarity.npz"))
    assert np.isfinite(np.asarray(tr.loss_hist)).all()
    entry = train_main(_cli(toy, root, "--start_state", "1", "--distill", "true"))
    assert entry.cur_state == 1 and entry.num_classes == C


@pytest.mark.parametrize("flags,want", [
    pytest.param(["--mas", "true"], "mas", id="flags6-item 4c"),
    pytest.param(["--agem", "true", "--sample_num", "2", "--sample_method", "random",
                  "--sample_batch_size", "2"], "agem", id="flags7-item 4c"),
    pytest.param(["--bic", "true", "--sample_num", "2", "--sample_method", "random",
                  "--sample_batch_size", "2"], "bic", id="flags8-item 4d"),
])
def test_train_cli_refuses_unported_methods_at_state1(toy, state0_run, run_dir, flags, want):
    """MAS, A-GEM and BiC (ROADMAP §1 items 4c and 4d, once refused here)
    through ``cli.train`` into state 1 (the cross-state entry from one
    state-0 checkpoint) on the CPU: the state-1 checkpoint is written and
    the method's work shows (the importance sidecar and a finite
    ``mas_loss`` in every step; the replay gradient, keyed like the
    expanded model; the trained state-1 BiC scalars in the checkpoint)."""
    dst = run_dir / "checkpoint" / "3_2" / "state0"
    shutil.copytree(os.path.join(state0_run, "epoch1"), dst / "epoch1")
    seen = []
    real_run = ILTrainer.run_batch

    def run_batch(self, batch, is_replay=False, sync_metrics=True, correction=False):
        m = real_run(self, batch, is_replay=is_replay, sync_metrics=True,
                     correction=correction)
        seen.append(m)
        return m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ILTrainer, "run_batch", run_batch)
        tr = train_main(_cli(toy, str(run_dir), "--start_state", "1", *flags))
    assert tr.cur_state == 1 and tr.ckpt.epochs(1) == [1] and seen
    meta = tr.ckpt.restore(1, 1)[1]
    if want == "mas":
        assert os.path.exists(os.path.join(tr.ckpt.state_dir(0), "mas_importance.npz"))
        assert all(np.isfinite(m["mas_loss"]) for m in seen)
    elif want == "agem":
        assert tr.agem is not None and tr.agem.replay_grad is not None
        assert tr.agem.replay_grad["classification_head.output.weight"].shape == \
            tr.model.classification_head.output.weight.shape
    else:
        assert meta["bic"]["alphas"] == tr.bic.params.alphas.tolist()
        assert meta["bic"]["alphas"][0] != 1.0


@pytest.fixture
def run_dir(tmp_path):
    """``tmp_path``, emptied after the test: a state-1 run writes ~270 MB
    of R18 checkpoints (parameters and Adam moments)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def state0_run(toy, tmp_path_factory):
    """One state-0 epoch through ``cli.train``, entered from by the cases
    below."""
    root = str(tmp_path_factory.mktemp("state0_run"))
    tr = train_main(_cli(toy, root, "--start_state", "0", "--end_state", "0"))
    yield tr.ckpt.state_dir(0)
    shutil.rmtree(root, ignore_errors=True)


# the ROADMAP §1 item 4b switches, once refused here; the replay-only ones
# run with replay (random exemplars, which need no foreground-ratio filter)
_REPLAY = ["--sample_num", "2", "--sample_method", "random", "--sample_batch_size", "2"]


def _il_override(**fields):
    """Set ILConfig sub-config fields that have no flag (as JAX's own tests
    set them in the config): {"replay": {...}, "prototype": {...}}."""
    def apply(cfg):
        il = cfg.il
        for sub, values in fields.items():
            il = dataclasses.replace(il, **{sub: dataclasses.replace(getattr(il, sub),
                                                                     **values)})
        return cfg.replace(il=il)
    return apply


@pytest.mark.parametrize("flags,override,want", [
    (["--sample_num", "2"], _il_override(replay=dict(herd_ratio_threshold=0.05)), "replay"),
    (["--enhance_error", "true", *_REPLAY], None, "enhance_loss"),
    (["--final_correction", "true", "--enhance_error", "true", *_REPLAY], None, "correction"),
    (["--mix_data", "true", *_REPLAY], None, "mixed"),
    (["--prototype_loss", "true", "--distill", "true"],
     _il_override(prototype=dict(start_epoch=0)), "prototype_loss"),
    (["--persuado_label", "true"], None, "pseudo"),
], ids=["sample_num", "enhance_error", "final_correction", "mix_data", "prototype_loss",
        "persuado_label"])
def test_train_cli_runs_4b_methods_into_state1(toy, state0_run, run_dir, flags, override,
                                               want):
    """Each item-4b flag through ``cli.train`` into state 1 (the
    cross-state entry from one state-0 checkpoint) on the CPU: state 1
    trains, every loss finite, and the flag's work shows. Herding runs at
    ``herd_ratio_threshold`` 0.05 and the prototype term from epoch 1
    (fields without a flag): the toy boxes are at most a quarter of the
    image, and ``start_epoch`` is 5 by default."""
    dst = run_dir / "checkpoint" / "3_2" / "state0"
    shutil.copytree(os.path.join(state0_run, "epoch1"), dst / "epoch1")
    seen = []
    real_run, real_init = ILTrainer.run_batch, ILTrainer.__init__

    def run_batch(self, batch, is_replay=False, sync_metrics=True, correction=False):
        m = real_run(self, batch, is_replay=is_replay, sync_metrics=True,
                     correction=correction)
        seen.append((is_replay, correction, set(m)))
        return m

    def init(self, cfg, *a, **k):
        real_init(self, override(cfg) if override else cfg, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ILTrainer, "run_batch", run_batch)
        mp.setattr(ILTrainer, "__init__", init)
        tr = train_main(_cli(toy, str(run_dir), "--start_state", "1", *flags))
    assert tr.cur_state == 1 and tr.ckpt.epochs(1) == [1] and seen
    assert np.isfinite(np.asarray(tr.loss_hist)).all()
    replay = [keys for r, c, keys in seen if r and not c]
    order = [r for r, c, _ in seen if not c]
    if want == "replay":
        ex = list(tr.dataset_replay.image_ids)
        assert ex and replay and tr.ckpt.restore(1, 1)[1]["exemplar_ids"] == ex
        assert tr.herd_sampler is not None and tr.herd_sampler.examplar_list == ex
    elif want == "enhance_loss":
        assert replay and all("enhance_loss" in k for k in replay)
    elif want == "correction":
        assert any(c for _, c, _ in seen)
    elif want == "mixed":                   # a new-image step after a replay one
        assert True in order and False in order[order.index(True):]
    elif want == "prototype_loss":
        assert tr.prototype_features is not None
        assert all("prototype_loss" in k for r, c, k in seen if not r)
    else:
        assert tr.teacher_model is not None
        assert set(tr.dataset_train.pseudo_labels) == set(tr.dataset_train.image_ids)
