"""The serving slice end to end on the CPU: the JAX package's
``make_predict_fn`` against the port's, from the same bridged weights
(labels and valid exact, boxes and scores at rtol 1e-4), and the port's
serve device loop answering queued frames as a direct predict call does."""
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.config import PredictConfig as JPredictConfig
from cl_object_detection_tpu.eval.predictor import make_predict_fn as j_make_predict
from cl_object_detection_tpu_torch.cli.serve import (
    device_loop,
    frame_spec,
    make_run_predict,
    submit,
)
from cl_object_detection_tpu_torch.config import PredictConfig
from cl_object_detection_tpu_torch.data.transforms import space_to_depth
from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn

from test_torch_model import H, W, jax_variables, port_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jmodel, v = jax_variables(seed=1)
    return jmodel, v, port_model(v)


def _frames(n, seed):
    r = np.random.RandomState(seed)
    return space_to_depth(r.randint(0, 256, (n, H, W, 3)).astype(np.uint8), factor=4)


@pytest.mark.parametrize("nms_impl", ["pallas_fp", "iterative"])
def test_predict_matches_jax(models, nms_impl):
    jmodel, v, tmodel = models
    kw = dict(pre_nms_topk=256, max_detections=40, score_thresh=0.05, nms_impl=nms_impl)
    jpred = j_make_predict(jmodel, JPredictConfig(**kw))
    tpred = make_predict_fn(tmodel, PredictConfig(**kw))
    x = _frames(2, 31)
    want = jpred(jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    got = tpred(torch.from_numpy(x))
    assert np.asarray(want.valid).sum() > 0
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-3)


def test_predict_class_affine_matches_jax(models):
    jmodel, v, tmodel = models
    kw = dict(pre_nms_topk=256, max_detections=40, nms_impl="pallas_fp")
    scale = np.array([1.0, 0.5, 2.0], np.float32)
    offset = np.array([0.0, 0.3, -0.2], np.float32)
    x = _frames(1, 32)
    want = j_make_predict(jmodel, JPredictConfig(**kw))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x), jnp.asarray(scale), jnp.asarray(offset))
    got = make_predict_fn(tmodel, PredictConfig(**kw))(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(offset))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-6)


def test_use_pallas_nms_does_not_reroute_pallas_fp(models, monkeypatch):
    """``nms_impl`` alone picks the NMS: ``use_pallas_nms=False`` leaves
    ``pallas_fp`` on ``ops.nms_fp.nms_fp`` (the kernel on the card)."""
    from cl_object_detection_tpu_torch.ops import nms_fp as nf

    _, _, tmodel = models
    calls = []
    real = nf.nms_fp
    monkeypatch.setattr(nf, "nms_fp", lambda b, s, t: calls.append(1) or real(b, s, t))
    cfg = PredictConfig(pre_nms_topk=200, nms_impl="pallas_fp", use_pallas_nms=False)
    make_predict_fn(tmodel, cfg)(torch.from_numpy(_frames(1, 34)))
    assert calls == [1]


def test_unported_options_are_refused(models):
    _, _, tmodel = models
    with pytest.raises(ValueError, match="quantize"):
        make_predict_fn(tmodel, PredictConfig(quantize=True))
    with pytest.raises(ValueError, match="approx"):
        make_predict_fn(tmodel, PredictConfig(topk_method="approx"))


def test_serve_device_loop_answers_like_direct_predict(models):
    _, _, tmodel = models
    predict = make_predict_fn(tmodel, PredictConfig(pre_nms_topk=256, nms_impl="pallas_fp"))
    run_predict = make_run_predict(predict, torch.device("cpu"))
    shape, dtype = frame_spec(H, W, s2d=False, fused=True, uint8=True)
    frames = _frames(3, 33)
    scales = [1.0, 0.5, 2.0]
    thresh = 0.05
    work, stop = queue.Queue(), threading.Event()
    loop = threading.Thread(target=device_loop, args=(work, run_predict, shape, dtype),
                            kwargs=dict(max_batch=2, batch_window_ms=50, request_ttl=120,
                                        score_thresh=thresh, stop=stop))
    loop.start()
    try:
        answers = [None] * 3

        def ask(i):
            answers[i] = submit(work, frames[i], scales[i], timeout=120)

        askers = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
        for t in askers:
            t.start()
        for t in askers:
            t.join(timeout=180)
            assert not t.is_alive()
    finally:
        stop.set()
        loop.join(timeout=30)
    assert not loop.is_alive()
    for i, ans in enumerate(answers):
        # a direct call on a batch of the loop's static size
        padded = np.zeros((2,) + shape, dtype)
        padded[0] = frames[i]
        det = run_predict(padded)
        keep = det["valid"][0] & (det["scores"][0] > thresh)
        want = det["boxes"][0][keep] / scales[i]
        assert ans is not None and "error" not in ans, ans
        got = ans["detections"]
        assert len(got) == int(keep.sum()) > 0
        np.testing.assert_allclose(np.array([d["box"] for d in got]), want, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal([d["class_id"] for d in got], det["labels"][0][keep])
