"""NMS port (cl_object_detection_tpu_torch.ops.nms / .nms_fp) against the
JAX package: keep masks bit-identical to JAX ``nms_iterative``,
``nms_padded`` and ``nms_pallas_batched`` (interpret mode), and
``detect_batch`` on shared logits and regression (labels and valid
exact, boxes and scores at rtol 1e-5), tied logits included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.ops import nms as jn
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.ops.nms_pallas import nms_pallas_batched
from cl_object_detection_tpu_torch.ops import nms as tn
from cl_object_detection_tpu_torch.ops import nms_fp as tfp

torch.set_num_threads(1)


def _random_case(b, k, seed):
    r = np.random.RandomState(seed)
    bb = r.rand(b, k, 4).astype(np.float32) * 600
    bb[..., 2:] = bb[..., :2] + 10 + r.rand(b, k, 2).astype(np.float32) * 60
    ss = np.sort(r.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    ss[:, int(k * 0.8):] = 0.0
    return bb, ss


def _near_threshold_case(k=256, seed=7):
    """Pairs with IoU exactly 0.5 by construction: unit-height boxes
    [x, x+2] vs [x+2/3, x+2+2/3]."""
    r = np.random.RandomState(seed)
    bb = np.zeros((k, 4), np.float32)
    xs = r.rand(k // 2).astype(np.float32) * 500
    bb[0::2] = np.stack([xs, np.zeros_like(xs), xs + 2, np.ones_like(xs)], 1)
    sh = np.float32(2.0 / 3.0)
    bb[1::2] = bb[0::2] + [sh, 0, sh, 0]
    ss = np.sort(r.rand(k).astype(np.float32))[::-1].copy()
    return bb[None], ss[None]


def _identical_case():
    b, k = 2, 256
    bb = np.tile(np.array([[10, 10, 50, 50]], np.float32), (k, 1))
    bb = np.stack([bb, bb + 100])
    ss = np.tile(np.linspace(1.0, 0.5, k).astype(np.float32), (b, 1))
    return bb, ss


CASES = {
    "b1k256": lambda: _random_case(1, 256, 3),
    "b4k512": lambda: _random_case(4, 512, 4),
    "b3k1024": lambda: _random_case(3, 1024, 5),
    "near_threshold": _near_threshold_case,
    "identical": _identical_case,
}


@pytest.mark.parametrize("case", list(CASES))
def test_keep_masks_bit_identical_to_jax(case):
    bb, ss = CASES[case]()
    want_pallas = np.asarray(nms_pallas_batched(jnp.asarray(bb), jnp.asarray(ss), 0.5,
                                                interpret=True))
    want_it = np.stack([np.asarray(jn.nms_iterative(jnp.asarray(b), jnp.asarray(s), 0.5))
                        for b, s in zip(bb, ss)])
    np.testing.assert_array_equal(want_pallas, want_it)
    tb, ts = torch.from_numpy(bb), torch.from_numpy(ss)
    np.testing.assert_array_equal(tn.nms_iterative(tb, ts, 0.5).numpy(), want_it)
    np.testing.assert_array_equal(tfp.nms_fp(tb, ts, 0.5).numpy(), want_it)
    np.testing.assert_array_equal(tn.nms_padded(tb, ts, 0.5).numpy(), want_it)
    if case == "identical":
        assert (want_it.sum(axis=1) == 1).all() and want_it[:, 0].all()


def test_nms_padded_per_image_matches_jax():
    bb, ss = _random_case(1, 256, 9)
    want = np.asarray(jn.nms_padded(jnp.asarray(bb[0]), jnp.asarray(ss[0]), 0.45))
    got = tn.nms_padded(torch.from_numpy(bb[0]), torch.from_numpy(ss[0]), 0.45)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_capacity_bound():
    assert tfp.max_k() >= 1024
    assert tfp.smem_bytes(tfp.max_k()) <= tfp.MAX_SMEM_BYTES < tfp.smem_bytes(tfp.max_k() + 32)


def _assert_detections_equal(got, want, rtol):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=rtol, atol=1e-7)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("impl,topk,logits", [
    ("pallas_fp", 256, True), ("iterative", 256, True), ("scan", 256, False),
    ("pallas_fp", 200, True)])
def test_detect_batch_matches_jax(impl, topk, logits):
    h, w = 64, 96
    anchors = anchors_for_shape(h, w)
    a = anchors.shape[0]
    r = np.random.RandomState(11)
    cls = (r.randn(2, a, 3).astype(np.float32) * 2 - 2) if logits else \
        r.rand(2, a, 3).astype(np.float32) * 0.5
    reg = (r.rand(2, a, 4).astype(np.float32) - 0.5) * 0.4
    kw = dict(height=h, width=w, pre_nms_topk=topk, max_detections=50,
              nms_impl=impl, scores_are_logits=logits)
    want = jn.detect_batch(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors), **kw)
    got = tn.detect_batch(torch.from_numpy(cls), torch.from_numpy(reg),
                          torch.from_numpy(anchors.copy()), **kw)
    assert np.asarray(want.valid).sum() > 10
    _assert_detections_equal(got, want, 1e-5)


@pytest.mark.parametrize("topk", [200, 256, 1000])
def test_pallas_fp_always_takes_the_kernel_wrapper(monkeypatch, topk):
    """``pallas_fp`` hands every k to ``ops.nms_fp.nms_fp`` (the kernel on
    a CUDA tensor); no k is re-routed to another NMS."""
    from cl_object_detection_tpu_torch.ops import nms_fp as nf

    seen = []
    real = nf.nms_fp
    monkeypatch.setattr(nf, "nms_fp", lambda b, s, t: seen.append(b.shape) or real(b, s, t))
    h, w = 64, 96
    anchors = torch.from_numpy(anchors_for_shape(h, w).copy())
    cls = torch.from_numpy(np.random.RandomState(13).randn(1, anchors.shape[0], 3)
                           .astype(np.float32))
    tn.detect_batch(cls, torch.zeros(1, anchors.shape[0], 4), anchors, height=h,
                    width=w, pre_nms_topk=topk, nms_impl="pallas_fp",
                    scores_are_logits=True)
    assert seen == [(1, topk, 4)]


def test_detect_batch_tied_logits_match_jax():
    """Every logit ties (a fresh model's zero output convs): lax.top_k
    puts the lower index first, and so must the port."""
    h, w = 64, 64
    anchors = anchors_for_shape(h, w)
    a = anchors.shape[0]
    cls = np.full((2, a, 4), -1.0, np.float32)
    cls[1, ::7, 2] = 0.5          # ties within a second score level
    reg = (np.random.RandomState(12).rand(2, a, 4).astype(np.float32) - 0.5) * 0.2
    kw = dict(height=h, width=w, pre_nms_topk=256, max_detections=64,
              nms_impl="pallas_fp", scores_are_logits=True)
    want = jn.detect_batch(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors), **kw)
    got = tn.detect_batch(torch.from_numpy(cls), torch.from_numpy(reg),
                          torch.from_numpy(anchors.copy()), **kw)
    _assert_detections_equal(got, want, 1e-5)


def test_approx_topk_is_refused():
    anchors = torch.from_numpy(anchors_for_shape(64, 64).copy())
    a = anchors.shape[0]
    with pytest.raises(ValueError, match="approx"):
        tn.detect_batch(torch.zeros(1, a, 2), torch.zeros(1, a, 4), anchors,
                        height=64, width=64, topk_method="approx")
