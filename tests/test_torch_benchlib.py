"""The port's ``utils/benchlib.py`` against the JAX package's: the chain
runs its step the stated number of times, ``time_chained`` times it, and
``make_predict_sum`` of a bridged R18 equals JAX's on the same seeded
frames at the detections bar (rtol 1e-4), under ``iterative`` and
``pallas_fp`` (JAX's Pallas NMS in interpret mode on the CPU, the port's
plain versions of its kernels)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.config import ModelConfig as JModelConfig
from cl_object_detection_tpu.config import PredictConfig as JPredictConfig
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.ops.anchors import anchors_for_shape as j_anchors
from cl_object_detection_tpu.utils import benchlib as jbench
from cl_object_detection_tpu_torch.config import PredictConfig
from cl_object_detection_tpu_torch.data.transforms import space_to_depth
from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
from cl_object_detection_tpu_torch.utils import benchlib

from test_torch_model import CFG, H, NUM_CLASSES, W, port_model

torch.set_num_threads(1)


def test_chain_runs_n_iterations():
    def step(x):
        return x.sum() * 0.0 + 1.0          # each iteration adds exactly 1

    out = benchlib.chain(step, 7)(torch.ones(2, 2))
    assert out.dtype == torch.float32 and out.dim() == 0
    assert float(out) == 7.0


def test_chain_feeds_each_result_back_in_the_inputs_dtype():
    seen = []

    def step(xs):
        seen.append([(t.dtype, t.clone()) for t in xs])
        return torch.tensor(1e12)           # acc * 1e-12 = number of steps so far

    frames = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    feats = torch.zeros(2, dtype=torch.float32)
    benchlib.chain(step, 3)((frames, feats))
    assert [[d for d, _ in s] for s in seen] == [[torch.uint8, torch.float32]] * 3
    for i, s in enumerate(seen):
        assert torch.equal(s[0][1], frames + i)
        assert torch.equal(s[1][1], feats + i)


def test_chain_keeps_no_graph_across_iterations():
    w = torch.ones(3, requires_grad=True)
    out = benchlib.chain(lambda x: (x * w).sum(), 4)(torch.ones(3))
    assert not out.requires_grad
    assert float(out) == pytest.approx(12.0)


def test_time_chained_is_positive():
    dt = benchlib.time_chained(lambda x: x.sum(), torch.ones(4, 4), iters=2, reps=1)
    assert dt > 0


def test_finite_positive_names_the_bad_figures():
    rec = {"ms": 1.0, "loss_ms": -0.5, "errors": 0, "launches": {"nms_fp": 0},
           "nested": {"p99_ms": float("nan")}, "neg_ms": -1.0, "ok": True, "note": "x"}
    assert benchlib.finite_positive(rec, ("loss_ms",)) == [".nested.p99_ms", ".neg_ms"]


def test_where_names_the_cpu():
    assert benchlib.where("cpu") == {"device": "cpu"}


def test_synthetic_gt_is_the_jax_tools():
    boxes, labels = benchlib.synthetic_gt(3)
    assert boxes.shape == (3, 32, 4) and labels.shape == (3, 32)
    assert (labels[:, :8] >= 0).all() and (labels[:, 8:] == -1).all()
    np.testing.assert_array_equal(boxes[1, 2], [96, 48, 192, 112])
    assert labels[2, 7] == (2 + 7) % 20


def seeded_variables(seed):
    """The small R18 of ``test_torch_model`` and seeded variables for it
    (the tree's shapes from ``jax.eval_shape``, so no flax init is
    compiled): He-normal convs, random frozen-BN statistics and affines,
    random output convs. Returns (JAX model, numpy variable tree)."""
    jmodel = j_create(JModelConfig(**CFG), NUM_CLASSES)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    r = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            std = 0.05 if "output" in str(path) else np.sqrt(2.0 / np.prod(shape[:2]) / shape[-1])
            return (r.randn(*shape) * std).astype(np.float32)
        if name == "var":
            return (np.abs(r.randn(*shape)) * 0.2 + 0.8).astype(np.float32)
        if name == "scale":
            return (1 + r.randn(*shape) * 0.1).astype(np.float32)
        return (r.randn(*shape) * 0.05).astype(np.float32)     # means, biases

    return jmodel, jax.tree_util.tree_map_with_path(fill, shapes)


def seeded_pair(seed, frames):
    """``seeded_variables`` with the classifier's output conv scaled so its
    logits on ``frames`` have std 1.5 (scores off the sigmoid's
    saturation, where float32 ties at 1.0 would make any sum agree).
    Returns (JAX model, variables, port model)."""
    jmodel, v = seeded_variables(seed)
    with torch.no_grad():
        logits, _ = port_model(v)(torch.from_numpy(frames), enable_act=False)
    out = v["params"]["classification_head"]["output"]
    bias = torch.from_numpy(out["bias"]).repeat(logits.shape[1] // out["bias"].size)
    out["kernel"] = out["kernel"] * np.float32(1.5 / float((logits[0] - bias[:, None]).std()))
    return jmodel, v, port_model(v)


@pytest.mark.parametrize("nms_impl", ["iterative", "pallas_fp"])
def test_predict_sum_matches_jax(nms_impl):
    frames = space_to_depth(
        np.random.RandomState(41).randint(0, 256, (2, H, W, 3)).astype(np.uint8), factor=4)
    jmodel, v, tmodel = seeded_pair(7, frames)
    kw = dict(pre_nms_topk=256, max_detections=40, nms_impl=nms_impl)
    jps = jbench.make_predict_sum(jmodel, jax.tree.map(jnp.asarray, v),
                                  jnp.asarray(j_anchors(H, W)), JPredictConfig(**kw), H, W)
    want = float(jax.jit(jps)(jnp.asarray(frames), *jps.consts))   # one compile, no chain
    tps = benchlib.make_predict_sum(tmodel, torch.tensor(anchors_for_shape(H, W)),
                                    PredictConfig(**kw), H, W)
    before = benchlib.launch_counts()
    got = tps(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert 1.0 < want < 79.0 and math.isfinite(want)     # 2 x 40 slots, off saturation
    assert float(got) == pytest.approx(want, rel=1e-4)
    assert benchlib.launches_since(before) == dict.fromkeys(before, 0)   # plain versions
