"""The port's focal loss and box helpers against the JAX package's, on the
same seeded numpy inputs in float32 on the CPU.

The batch has an image without GT, an image with two identical GT boxes
of different labels (an IoU tie, which the first GT must win), and
anchors at exactly 0.4 and 0.5 IoU (the band edges), besides the anchor
grid of a 64 x 96 frame. Some probabilities sit exactly on the clip
bounds 1e-4 and 1 - 1e-4, where ``jnp.clip``'s gradient is 0.5.

Tolerances: losses and ``num_pos`` at rtol 1e-5, atol 1e-6 (sums taken
in another order); ``bg_mask`` and ``pos_label`` exact; gradients with
respect to ``cls_prob`` and ``regression`` against ``jax.grad`` at rtol
1e-4, atol 1e-7. ``encode_boxes`` at rtol 1e-5; ``positive_assignment``
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.ops import boxes as jboxes
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.ops.focal_loss import focal_loss as j_focal
from cl_object_detection_tpu_torch.ops import boxes as tboxes
from cl_object_detection_tpu_torch.ops.focal_loss import focal_loss as t_focal

torch.set_num_threads(1)

C = 5
EDGE_ANCHORS = np.array([[0, 0, 10, 5],       # IoU 0.5 with [0, 0, 10, 10]
                         [0, 0, 10, 4],       # IoU 0.4
                         [0, 0, 10, 10],      # IoU 1
                         [50, 40, 90, 80],    # IoU 1 with both tied GT boxes
                         [52, 40, 92, 80]], np.float32)


def make_batch(seed=0):
    r = np.random.RandomState(seed)
    anchors = np.concatenate([anchors_for_shape(64, 96), EDGE_ANCHORS]).astype(np.float32)
    a = anchors.shape[0]
    b, m = 4, 6
    boxes = np.full((b, m, 4), -1, np.float32)
    labels = np.full((b, m), -1, np.int32)
    boxes[0, 0], labels[0, 0] = [0, 0, 10, 10], 1
    boxes[0, 1], labels[0, 1] = [20, 8, 60, 50], 3
    # image 1: no GT at all
    boxes[2, 0], labels[2, 0] = [50, 40, 90, 80], 4     # two identical boxes:
    boxes[2, 1], labels[2, 1] = [50, 40, 90, 80], 0     # the first GT wins
    boxes[2, 2], labels[2, 2] = [4, 30, 36, 62], 2
    for j in range(4):
        x, y = r.uniform(0, 60), r.uniform(0, 30)
        boxes[3, j] = [x, y, x + r.uniform(8, 40), y + r.uniform(8, 40)]
        labels[3, j] = r.randint(0, C)
    prob = r.uniform(0.0, 1.0, (b, a, C)).astype(np.float32)
    prob[:, ::37, 0] = np.float32(1e-4)           # on the lower clip bound
    prob[:, 5::41, 1] = np.float32(1.0 - 1e-4)    # on the upper one
    prob[:, 3::29, 2] = 1e-6                      # below it
    reg = (r.randn(b, a, 4) * 0.5).astype(np.float32)
    return prob, reg, anchors, boxes, labels


VARIANTS = {
    "plain": {},
    "alpha_gamma": dict(alpha=0.3, gamma=1.5),
    "incremental": dict(incremental=True, num_past_class=2),
    "ignore_past_class": dict(incremental=True, num_past_class=2, ignore_past_class=True),
    "new_ignore_past_class": dict(incremental=True, num_past_class=2, ignore_past_class=True,
                                  new_ignore_past_class=True),
    "decrease_positive": dict(incremental=True, num_past_class=2, decrease_positive=0.6),
    "decrease_positive_by_iou": dict(incremental=True, num_past_class=2,
                                     decrease_positive_by_iou=True),
    "enhance_on_new": dict(incremental=True, num_past_class=2, enhance_on_new=True),
    "pseudo_progress": dict(incremental=True, num_past_class=2, pseudo_progress=0.3),
    "pseudo_progress_off": dict(incremental=True, num_past_class=2, pseudo_progress=-1.0),
}
LOSS_FIELDS = ("bg_loss", "fg_loss", "reg_loss", "enhance_on_new_loss")


def _jax_kwargs(kw):
    kw = dict(kw)
    if "pseudo_progress" in kw:
        kw["pseudo_progress"] = jnp.float32(kw["pseudo_progress"])
    return kw


def _torch_kwargs(kw):
    kw = dict(kw)
    if "pseudo_progress" in kw:
        kw["pseudo_progress"] = torch.tensor(kw["pseudo_progress"], dtype=torch.float32)
    return kw


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_focal_loss_matches_jax(variant):
    prob, reg, anchors, boxes, labels = make_batch()
    kw = VARIANTS[variant]
    weights = np.array([0.7, 1.3, 0.9, 0.5], np.float32)

    def j_scalar(p, r):
        out = j_focal(p, r, jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(labels),
                      **_jax_kwargs(kw))
        s = sum(w * jnp.sum(getattr(out, f)) for w, f in zip(weights, LOSS_FIELDS))
        return s, out

    (_, jout), (jgp, jgr) = jax.value_and_grad(j_scalar, argnums=(0, 1), has_aux=True)(
        jnp.asarray(prob), jnp.asarray(reg))

    tp = torch.from_numpy(prob).requires_grad_(True)
    tr = torch.from_numpy(reg).requires_grad_(True)
    tout = t_focal(tp, tr, torch.from_numpy(anchors), torch.from_numpy(boxes),
                   torch.from_numpy(labels), **_torch_kwargs(kw))
    total = sum(float(w) * getattr(tout, f).sum() for w, f in zip(weights, LOSS_FIELDS))
    total.backward()

    for f in LOSS_FIELDS + ("num_pos",):
        np.testing.assert_allclose(getattr(tout, f).detach().numpy(), np.asarray(getattr(jout, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tout.bg_mask.numpy(), np.asarray(jout.bg_mask))
    np.testing.assert_array_equal(tout.pos_label.numpy(), np.asarray(jout.pos_label))
    assert tout.pos_label.dtype == torch.int32
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), rtol=1e-4, atol=1e-7)


def test_focal_loss_fixture_cases():
    """The fixture holds what it claims: the band edges land in the
    ignore band (0.4) and fg (0.5), the empty-GT image has no positive
    and a bg loss, the tied GT gives its anchors the first GT's label,
    and a probability on the clip bound gets half the gradient."""
    prob, reg, anchors, boxes, labels = make_batch()
    a0 = anchors.shape[0] - len(EDGE_ANCHORS)
    out = t_focal(torch.from_numpy(prob), torch.from_numpy(reg), torch.from_numpy(anchors),
                  torch.from_numpy(boxes), torch.from_numpy(labels))
    assert not bool(out.bg_mask[0, a0])                   # IoU 0.5: positive
    assert bool(out.bg_mask[0, a0 + 1])                   # IoU 0.4: not positive...
    assert int(out.pos_label[0, a0 + 1]) == -1
    assert float(out.num_pos[1]) == 0 and float(out.fg_loss[1]) == 0
    assert float(out.bg_loss[1]) > 0
    assert int(out.pos_label[2, a0 + 3]) == 4             # the first of the tied GT
    assert int(out.pos_label[2, a0 + 4]) == 4

    # ...and in the ignore band: its background columns carry no loss
    def bg_of_anchor(p):
        return t_focal(p, torch.from_numpy(reg), torch.from_numpy(anchors),
                       torch.from_numpy(boxes), torch.from_numpy(labels)).bg_loss[0]

    p = torch.from_numpy(prob).requires_grad_(True)
    bg_of_anchor(p).backward()
    assert float(p.grad[0, a0 + 1].abs().sum()) == 0.0

    # clip bound: jnp.clip and the port both pass half the gradient at a tie
    x = torch.tensor([1e-4, 0.5, 1.0 - 1e-4, 1e-6], dtype=torch.float32, requires_grad=True)
    from cl_object_detection_tpu_torch.ops.focal_loss import _clip

    _clip(x, 1e-4, 1.0 - 1e-4).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jnp.clip(v, 1e-4, 1.0 - 1e-4)))(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(x.grad.numpy(), [0.5, 1.0, 0.5, 0.0])


def test_encode_boxes_matches_jax():
    r = np.random.RandomState(3)
    anchors = np.concatenate([anchors_for_shape(64, 96), EDGE_ANCHORS]).astype(np.float32)
    gt = anchors + r.randn(*anchors.shape).astype(np.float32) * 6
    gt[::7, 2] = gt[::7, 0] + 0.25                 # width below 1: clamped
    gt[::11, 3] = gt[::11, 1] - 2.0                # negative height: clamped
    want = np.asarray(jboxes.encode_boxes(jnp.asarray(anchors), jnp.asarray(gt)))
    got = tboxes.encode_boxes(torch.from_numpy(anchors), torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_positive_assignment_matches_jax():
    prob, reg, anchors, boxes, labels = make_batch()
    for i in range(boxes.shape[0]):
        jpos, jlab = jboxes.positive_assignment(jnp.asarray(anchors), jnp.asarray(boxes[i]),
                                                jnp.asarray(labels[i]))
        tpos, tlab = tboxes.positive_assignment(torch.from_numpy(anchors),
                                                torch.from_numpy(boxes[i]),
                                                torch.from_numpy(labels[i]))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
