"""The IL tool passes on the port's data axis (JAX's
tests/test_tool_sharding.py mirrored), on the CPU: the similarity, the MAS
importance, herding, the prototypes with both prototype-herd modes and
the pseudo-labels, each with ``mesh=`` on two gloo ranks
(``tests/torch_mesh_worker.py``, one spawn for the file).

Each rank runs its whole batches of the pass's loader, round robin, and
the results are gathered back into the loader's order, so both ranks hold
one process's values bit for bit; the MAS importance adds the ranks' sums
in another order, so it is held at rtol 1e-5. The state-1 images make an
odd number of batches: the ranks hold unequal counts. The ranks' results
then hold to the JAX functions on the same model and images, at the bars
of the port's single-process tests against JAX
(tests/test_torch_il_state1.py, test_torch_il_replay.py): the similarity
within 1e-6, the prototypes and the prototype-herd scores at rtol 1e-4,
the exemplar picks equal, the pseudo-labels' images, counts and classes
equal and their scores at rtol 1e-4, their boxes at rtol 1e-4 and 1e-4 of
the box's largest coordinate (a box at the image's edge has a coordinate
near 0, whose rounding an rtol alone does not cover). The importance is not
held to JAX at the gradient bar here: on this toy set one process's
importance already parts from JAX's beyond it, and
``test_mas_gap_to_jax_is_float32_relu_flips`` pins that gap, batch by
batch, as float32 ReLU flips against a float64 evaluation (ROADMAP §3);
the port's importance is held to JAX's at the bar in
tests/test_torch_il_mas_agem.py.

An old model of scenario 3+2 (R18, FPN 32, 2 head layers, float32: JAX's
initialization, its output convs random and its classification bias
raised so that old-class scores pass the similarity gate and the
pseudo-label threshold) over 16 toy images at 128 x 192 frames; herding
keeps every (image, class) pair whose boxes cover 5% of the image (the toy
boxes are small).
"""
import contextlib
import os
import sys

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
from cl_object_detection_tpu.il import mas as jmas
from cl_object_detection_tpu.il import prototype as jproto
from cl_object_detection_tpu.il.pseudo_label import generate_pseudo_labels as j_pseudo
from cl_object_detection_tpu.il.weight_init import compute_similarity as j_similarity
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.ops.anchors import anchors_for_shape
from cl_object_detection_tpu.states import ILStates as JILStates
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.il import mas
from cl_object_detection_tpu_torch.il.prototype import sample_by_scores, sample_by_slot_scores
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables, port_name
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import (case_tools, float64_plain_path, run_ranks,  # noqa: E402
                               shared_result)

torch.set_num_threads(2)

MODEL = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
BIAS_RAISE = 3.0
DATA = dict(batch_size=4, min_side=100, max_side=192, height=128, width=192, max_boxes=8,
            num_workers=0, prefetch=0)
HERD_RATIO = 0.05
PSEUDO = dict(enabled=True, score_thresh=0.2)


def _jax_model():
    """JAX's old model (3 classes): its initialization, the output convs'
    kernels random and the classification bias raised."""
    model = j_create(jcfg.ModelConfig(**MODEL), 3)
    v = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 128, 192, 3))))
    r = np.random.RandomState(1)
    for head in ("classification_head", "regression_head"):
        out = v["params"][head]["output"]
        out["kernel"] = (r.randn(*out["kernel"].shape) * 0.01).astype(np.float32)
    v["params"]["classification_head"]["output"]["bias"] = (
        v["params"]["classification_head"]["output"]["bias"] + BIAS_RAISE).astype(np.float32)
    return model, v


def _anchors(images):
    return anchors_for_shape(images.shape[1], images.shape[2])


def _jax_passes(model, v, json_path, images, prototypes):
    """The JAX functions of every pass but MAS on the same model and
    images; the prototype-herd scores against ``prototypes`` (the
    ranks')."""
    coco = JCocoJson(json_path)
    states = JILStates(list(coco.classes.values()), coco.classes_inverse, ["3", "2"])
    old, new = (JILDataset(coco, states, images, split="train", start_state=s) for s in (0, 1))
    cfg = jcfg.DataConfig(**DATA)
    unaugmented = lambda ds: JBatchLoader(ds, cfg, shuffle=False, augment=False)  # noqa: E731
    herd = jherding.HerdSampler(model, HERD_RATIO)
    out = dict(
        similarity=np.asarray(j_similarity(model, v, _anchors, unaugmented(new), 2, 3)),
        herd=herd.sample(v, old, cfg, 2),
        prototypes=np.asarray(jproto.compute_prototype_features(model, v, _anchors,
                                                                unaugmented(old), 3)),
        pseudo=j_pseudo(model, v, new, cfg, jcfg.PseudoLabelConfig(**PSEUDO),
                        states.inverse_label_map()),
        proto_slots=jproto.prototype_herd_slot_scores(model, v, _anchors, old, cfg, prototypes),
        proto_mean=jproto.prototype_herd_scores(model, v, _anchors, old, cfg, prototypes))
    out["herd_list"] = list(herd.examplar_list)
    return out


def _compute(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy_mesh_tools"))
    json_path = make_toy_dataset(root, num_images=16, seed=5, image_size=(48, 64))
    images = os.path.join(root, "images")
    _, v = _jax_model()
    model = create_retinanet(tcfg.ModelConfig(**MODEL), 3, device="cpu")
    load_jax_variables(model, v)
    args = dict(json=json_path, images=images, model_cfg=tcfg.ModelConfig(**MODEL),
                state_dict=model.state_dict(), data_cfg=tcfg.DataConfig(**DATA),
                herd_ratio=HERD_RATIO, pseudo_cfg=tcfg.PseudoLabelConfig(**PSEUDO))
    ranks = run_ranks(str(tmp_path_factory.mktemp("mesh_tools")), "tools", args)
    one = case_tools(None, args, root)
    return ranks, one, dict(variables=v, json=json_path, images=images)


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """The ranks' and one process's passes (one spawn, computed once per
    session and shared across test workers), and their inputs; the JAX
    side runs in its test, so a test worker waits only for this."""
    return shared_result(tmp_path_factory, "mesh_tools", lambda: _compute(tmp_path_factory))


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return a == b


def test_tool_passes_on_two_ranks_equal_one_process(tools):
    """Every pass's result on both ranks equals one process's (the MAS
    importance at rtol 1e-5), with unequal batch counts on the ranks, and
    the passes give something to compare: a nonzero similarity and
    importance, exemplar picks, and pseudo-labels. (One test: the passes
    share one spawn.)"""
    ranks, one, _ = tools
    for key in ("similarity", "importance", "herd", "herd_list", "prototypes",
                "proto_slots", "proto_mean", "pseudo"):
        assert _equal(ranks[0][key], ranks[1][key]), key
        if key != "importance":
            assert _equal(ranks[0][key], one[key]), key
    for k, v in one["importance"].items():
        np.testing.assert_allclose(ranks[0]["importance"][k], v, rtol=1e-5, atol=0, err_msg=k)
    counts = [r["batches"] for r in ranks]
    assert one["batches"]["new"] % 2, one["batches"]
    for name, n in one["batches"].items():
        assert (counts[0][name], counts[1][name]) == ((n + 1) // 2, n // 2), name
    assert one["similarity"].sum() > 0
    assert any(v.any() for v in one["importance"].values())
    assert one["herd_list"] and any(one["pseudo"].values())
    assert any(one["proto_mean"].values())


def test_tool_passes_on_two_ranks_hold_to_jax(tools):
    """The ranks' results against the JAX functions on the same model and
    images (module docstring): each pass but MAS at its single-process
    bar."""
    ranks, _, inputs = tools
    got = ranks[0]
    want = _jax_passes(j_create(jcfg.ModelConfig(**MODEL), 3), inputs["variables"],
                       inputs["json"], inputs["images"], got["prototypes"])
    np.testing.assert_allclose(got["similarity"], want["similarity"], atol=1e-6, rtol=0)
    assert got["herd"] == want["herd"] and got["herd_list"] == want["herd_list"]
    np.testing.assert_allclose(got["prototypes"], want["prototypes"], rtol=1e-4,
                               atol=1e-5 * np.abs(want["prototypes"]).max())
    (scores, counts), (jscores, jcounts) = got["proto_slots"], want["proto_slots"]
    np.testing.assert_array_equal(counts, jcounts)
    flat = [(c, s, i) for c in jscores for s in jscores[c] for i in jscores[c][s]]
    assert flat == [(c, s, i) for c in scores for s in scores[c] for i in scores[c][s]]
    w = np.asarray([jscores[c][s][i] for c, s, i in flat])
    np.testing.assert_allclose([scores[c][s][i] for c, s, i in flat], w, rtol=1e-4,
                               atol=1e-4 * w.max())
    kw = dict(classes=range(3), num_anchors=9)
    assert sample_by_slot_scores(scores, counts, 2, **kw) == \
        sample_by_slot_scores(jscores, jcounts, 2, **kw)
    mean, jmean = got["proto_mean"], want["proto_mean"]
    assert {c: sorted(d) for c, d in mean.items()} == {c: sorted(d) for c, d in jmean.items()}
    flat = [(c, i) for c in jmean for i in jmean[c]]
    w = np.asarray([jmean[c][i] for c, i in flat])
    np.testing.assert_allclose([mean[c][i] for c, i in flat], w, rtol=1e-4, atol=1e-4 * w.max())
    assert sample_by_scores(mean, 2) == sample_by_scores(jmean, 2)
    pseudo, jpseudo = got["pseudo"], want["pseudo"]
    assert list(pseudo) == list(jpseudo)
    assert [len(a) for a in pseudo.values()] == [len(a) for a in jpseudo.values()]
    for img_id, anns in jpseudo.items():
        for g, j in zip(pseudo[img_id], anns):
            assert g["category_id"] == j["category_id"]
            # a coordinate near 0 (a box at the image's edge) also gets
            # 1e-4 of the box's largest coordinate
            np.testing.assert_allclose(g["bbox"], j["bbox"], rtol=1e-4,
                                       atol=1e-4 * np.abs(j["bbox"]).max())
            np.testing.assert_allclose(g["score"], j["score"], rtol=1e-4)


# ------------------------------------------------- MAS against JAX, per batch

EPS32 = float(np.finfo(np.float32).eps)


def _gradient_bar(got, want):
    """The train step's gradient bar, leaf for leaf: |d| <= 1e-3 |want| +
    1e-4 max|want|."""
    return all((np.abs(got[k] - w) <= 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).all()
               for k, w in want.items())


def _port_importance(v, batch, dtype=torch.float32, gates=None, record=None):
    """The port's importance of one batch (``mas.make_importance_step``,
    masked) as float64 numpy: in ``dtype`` (float64: the plain path);
    ``record`` collects every ReLU's input; ``gates`` (one boolean tensor
    per ReLU, in call order) replaces each ReLU by a product with its
    gate, which equals the ReLU but where the gate says otherwise."""
    model = create_retinanet(tcfg.ModelConfig(**MODEL), 3, device="cpu")
    load_jax_variables(model, v)
    real, calls = torch.nn.functional.relu, []

    def relu(x, *a, **k):
        calls.append(x)
        if record is not None:
            record.append(x.detach().double())
        return x * gates[len(calls) - 1].to(x.dtype) if gates is not None else real(x, *a, **k)

    torch.nn.functional.relu = relu
    try:
        with float64_plain_path(model) if dtype == torch.float64 else contextlib.nullcontext():
            step = mas.make_importance_step(model)
            g = step(*(torch.tensor(a, dtype=dtype if a.dtype == np.float32 else None)
                       for a in (_anchors(batch.images), batch.images, batch.boxes,
                                 batch.labels)))
    finally:
        torch.nn.functional.relu = real
    mask = mas.importance_mask(dict(model.named_parameters()))
    return {k: (x * mask[k]).double().numpy() for k, x in g.items()}


def test_mas_gap_to_jax_is_float32_relu_flips(tmp_path):
    """ROADMAP §3: the MAS importance of this file's model and state-0
    images parts from JAX's past the gradient bar, and the gap is float32
    rounding. Per batch of the pass (JAX's loader's images, given to both
    sides), against the port's plain path in float64: every ReLU input
    that the port's float32 puts on the other side of zero than float64
    lies within 4 float32 eps of its tensor's largest, and the port has
    such flips; with each ReLU gated as float64 gates it, the port's
    float32 importance holds to float64 at the gradient bar on every
    batch, and to JAX's wherever JAX's holds to float64; where JAX's does
    not, a one-ulp move of JAX's weights brings it there (a flip of
    JAX's own). The ranks hold the one-process importance at rtol 1e-5
    (test_tool_passes_on_two_ranks_equal_one_process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_mas_gap(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _check_mas_gap(tmp_path):
    json_path = make_toy_dataset(str(tmp_path), num_images=16, seed=5, image_size=(48, 64))
    coco = JCocoJson(json_path)
    states = JILStates(list(coco.classes.values()), coco.classes_inverse, ["3", "2"])
    old = JILDataset(coco, states, os.path.join(str(tmp_path), "images"), split="train",
                     start_state=0)
    batches = list(JBatchLoader(old, jcfg.DataConfig(**DATA), shuffle=False, augment=False))
    jmodel, v = _jax_model()
    jstep, jmask = jmas.make_importance_step(jmodel), jmas.importance_mask(v["params"])
    r = np.random.RandomState(2)
    moved = jax.tree.map(lambda x: np.nextafter(x, x + r.randn(*x.shape).astype(x.dtype)), v)

    def jax_importance(variables, b):
        g = jstep(variables, jnp.asarray(_anchors(b.images)), b.images, b.boxes, b.labels)
        out = {}
        for path, x in jax.tree_util.tree_leaves_with_path(jax.tree.map(jnp.multiply, g, jmask)):
            x = np.asarray(x, np.float64)
            out[port_name(("params",) + tuple(p.key for p in path))] = (
                x.transpose(3, 2, 0, 1) if x.ndim == 4 else x)
        return out

    def far(got, exact):
        return max(np.abs(got[k] - e).max() / max(np.abs(e).max(), 1e-30) / EPS32
                   for k, e in exact.items())

    gaps, flips, jax_flips = [], 0, 0
    for i, b in enumerate(batches):
        x32, x64 = [], []
        port = _port_importance(v, b, record=x32)
        exact = _port_importance(v, b, torch.float64, record=x64)
        gated = _port_importance(v, b, gates=[x > 0 for x in x64])
        want = jax_importance(v, b)
        assert len(x32) == len(x64)
        for a, e in zip(x32, x64):
            flip = (a > 0) != (e > 0)
            flips += int(flip.sum())
            assert (e[flip].abs() <= 4 * EPS32 * e.abs().max()).all(), (i, e[flip])
        gaps.append(not _gradient_bar(port, want))
        assert _gradient_bar(gated, exact), (i, far(gated, exact))
        if _gradient_bar(want, exact):
            assert _gradient_bar(gated, want), (i, far(gated, want))
        else:
            jax_flips += 1
            assert _gradient_bar(jax_importance(moved, b), exact), i
        print(f"MAS batch {i}, float32 eps of the leaf's largest: port {far(port, exact):.0f}, "
              f"gated port {far(gated, exact):.0f}, JAX {far(want, exact):.0f} from float64")
    assert any(gaps) and flips and jax_flips, (gaps, flips, jax_flips)
