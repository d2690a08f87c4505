"""int8 quantized predict path of the port (``ops/quant.py``,
``ops/int8_matmul.py``) against the JAX package, on the CPU.

* ``quantized_conv`` bit-identical to JAX ``ops.quant.quantized_conv`` in
  float32 (the same quantize formulas; the int8 product is exact on both
  sides);
* ``int8_matmul_reference`` bit-identical to the tool's
  ``_pallas_int8_matmul`` in Pallas interpret mode (bf16 out), and to an
  int64 numpy product with the same float32 epilogue;
* ``quantized_apply`` on the small R18 of ``test_torch_model.py`` against
  JAX ``quantized_apply``, the convs it leaves float, and against the
  model's own float path;
* quantized ``make_predict_fn`` against JAX ``make_predict_fn(quantize=
  True)``, and float and quantized predict of one model side by side.
"""
import functools
import importlib.util
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.config import PredictConfig as JPredictConfig
from cl_object_detection_tpu.eval.predictor import make_predict_fn as j_make_predict
from cl_object_detection_tpu.ops import quant as jq
from cl_object_detection_tpu_torch.config import PredictConfig
from cl_object_detection_tpu_torch.data.transforms import space_to_depth
from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables
from cl_object_detection_tpu_torch.ops import int8_matmul as tim
from cl_object_detection_tpu_torch.ops import quant as tq

from test_torch_model import H, W, jax_variables, port_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conv_inputs(k, cin, cout, hw, seed, bias):
    r = np.random.RandomState(seed)
    x = r.randn(2, *hw, cin).astype(np.float32)
    w = (r.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    b = (r.randn(cout) * 0.1).astype(np.float32) if bias else None
    return x, w, b


def _port_conv(x_nhwc, w_hwio, b, stride, padding):
    """The port's quantized_conv on an NCHW view of NHWC memory, back to
    NHWC numpy."""
    y = tq.quantized_conv(
        torch.from_numpy(x_nhwc).permute(0, 3, 1, 2),
        torch.from_numpy(w_hwio).permute(3, 2, 0, 1),
        None if b is None else torch.from_numpy(b), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("hw", [(16, 24), (17, 19)])
def test_quantized_conv_bit_identical_to_jax(k, stride, bias, hw):
    x, w, b = _conv_inputs(k, 8, 16, hw, seed=k * 10 + stride + hw[1], bias=bias)
    # the flax convs: 3x3 with padding 1, 1x1 with the default 'SAME'
    want = np.asarray(jq.quantized_conv(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        strides=stride, padding=1 if k == 3 else "SAME"))
    got = _port_conv(x, w, b, stride, 1 if k == 3 else 0)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_quantized_conv_exact_for_representable_values():
    """The JAX test's exact-grid case (tests/test_quant.py): integer
    values in [-127, 127] whose maxima are 127 quantize with scale 1, so
    the int8 conv equals the float conv, and JAX's, exactly."""
    x = np.random.RandomState(0).randint(-127, 128, (1, 8, 8, 4)).astype(np.float32)
    x[0, 0, 0, 0] = 127.0
    w = np.random.RandomState(1).randint(-127, 128, (1, 1, 4, 4)).astype(np.float32)
    w[0, 0, 0, :] = 127.0
    got = _port_conv(x, w, None, 1, 0)
    np.testing.assert_array_equal(got, np.einsum("bhwi,io->bhwo", x, w[0, 0]))
    want = jq.quantized_conv(jnp.asarray(x), jnp.asarray(w), None, strides=1,
                             padding="VALID")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_quantized_conv_refuses_dilation_and_groups():
    x = torch.zeros(1, 4, 8, 8)
    w = torch.ones(4, 4, 3, 3)
    with pytest.raises(ValueError, match="dilation"):
        tq.quantized_conv(x, w, None, stride=1, padding=1, dilation=2)
    with pytest.raises(ValueError, match="groups"):
        tq.quantized_conv(x, w, None, stride=1, padding=1, groups=2)


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_int8_matmul", os.path.join(REPO, "tools", "bench_int8_matmul.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m,k,n,bm,bn", [(256, 576, 256, 128, 128),
                                         (128, 2304, 256, 64, 256)])
def test_int8_matmul_reference_bit_identical_to_pallas_interpret(monkeypatch, m, k, n, bm, bn):
    """The tool's kernel runs on the CPU in Pallas interpret mode: the
    tool imports ``pallas`` inside the function, so patching
    ``pallas_call`` there reaches it without editing the tool."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    tool = _load_tool()
    r = np.random.RandomState(m + k)
    x8 = r.randint(-127, 128, (m, k)).astype(np.int8)
    w8 = r.randint(-127, 128, (k, n)).astype(np.int8)
    want = np.asarray(tool._pallas_int8_matmul(bm, bn, jnp.asarray(x8), jnp.asarray(w8), 1e-4))
    scale = torch.full((n,), 1e-4, dtype=torch.float32)
    got = tim.int8_matmul_reference(torch.from_numpy(x8), torch.from_numpy(w8.T.copy()), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_reference_matches_int64_numpy(with_bias, out_dtype):
    r = np.random.RandomState(7)
    m, k, n = 37, 300, 70
    x8 = r.randint(-128, 128, (m, k)).astype(np.int8)
    w8 = r.randint(-128, 128, (n, k)).astype(np.int8)
    scale = (r.rand(n) * 1e-3).astype(np.float32)
    bias = (r.randn(n)).astype(np.float32) if with_bias else None
    acc = x8.astype(np.int64) @ w8.astype(np.int64).T
    y = acc.astype(np.float32) * scale
    if with_bias:
        y = y + bias
    want = torch.from_numpy(y).to(out_dtype)
    got = tim.int8_matmul(torch.from_numpy(x8), torch.from_numpy(w8), torch.from_numpy(scale),
                          None if bias is None else torch.from_numpy(bias), out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, want)


def test_int8_matmul_wrapper_on_cpu_runs_the_plain_version_without_counting():
    r = np.random.RandomState(8)
    x = torch.from_numpy(r.randint(-127, 128, (9, 40)).astype(np.int8))
    w = torch.from_numpy(r.randint(-127, 128, (5, 40)).astype(np.int8))
    scale = torch.full((5,), 0.01)
    before = tim.int8_matmul.launches
    assert torch.equal(tim.int8_matmul(x, w, scale), tim.int8_matmul_reference(x, w, scale))
    assert tim.int8_matmul.launches == before
    with pytest.raises(TypeError, match="int8"):
        tim.int8_matmul(x.float(), w, scale)
    with pytest.raises(ValueError, match="scale"):
        tim.int8_matmul(x, w, torch.ones(4))
    assert tim.int8_matmul.launches == before


# ---- the quantized model ----

@pytest.fixture(scope="module")
def pair():
    """The small R18 with its output convs scaled down, so logits (std
    about 1) and scores are not saturated and the detections compare."""
    jmodel, v = jax_variables(seed=3)
    for head in ("classification_head", "regression_head"):
        v["params"][head]["output"]["kernel"] *= np.float32(0.05)
    return jmodel, v, port_model(v)


def _input(form, seed=22, n=2):
    r = np.random.RandomState(seed)
    if form == "rgb":
        return (r.randn(n, H, W, 3) * 0.5).astype(np.float32)
    if form == "fused_float":
        return space_to_depth((r.randn(n, H, W, 3) * 0.5).astype(np.float32), factor=4)
    return space_to_depth(r.randint(0, 256, (n, H, W, 3)).astype(np.uint8), factor=4)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("form", ["rgb", "fused_float", "fused_uint8"])
def test_quantized_model_matches_jax(pair, form):
    """Relative L2 <= 1e-5 against JAX ``quantized_apply``, float32. Each
    int8 conv is bit-identical; the float parts (stem, BN, head outputs)
    differ in summation order, which flips a rare int8 rounding. Measured
    on this model: 3.3e-7 (RGB) and 1.1e-7 (fused stem, float and uint8)
    or less, on logits and regression."""
    jmodel, v, tmodel = pair
    x = _input(form)
    jcls, jreg = jq.quantized_apply(jmodel)(v, jnp.asarray(x), enable_act=False)
    with torch.no_grad():
        tcls, treg = tq.quantized_apply(tmodel)(torch.from_numpy(x), enable_act=False)
    assert _rel_l2(tcls.numpy(), np.asarray(jcls)) <= 1e-5
    assert _rel_l2(treg.numpy(), np.asarray(jreg)) <= 1e-5


def test_output_convs_and_stem_stay_float(pair, monkeypatch):
    """A spy on ``quantized_conv``, as tests/test_quant.py spies on JAX's:
    the heads' ``output`` convs (27 = 9 anchors x 3 classes and 36 = 9 x 4
    channels) and the stem never run int8; every other conv runs int8 once
    per level: 19 backbone convs of the R18, 8 FPN convs, 2 heads x 2
    trunk convs x 5 levels."""
    _, _, tmodel = pair
    seen = []
    real = tq.quantized_conv

    def spy(x, weight, bias, **kw):
        seen.append(tuple(weight.shape))
        return real(x, weight, bias, **kw)

    monkeypatch.setattr(tq, "quantized_conv", spy)
    with torch.no_grad():
        tq.quantized_apply(tmodel)(torch.from_numpy(_input("fused_uint8", n=1)), enable_act=False)
    assert len(seen) == 19 + 8 + 2 * 2 * 5
    assert all(s[0] not in (27, 36) for s in seen)
    assert (64, 3, 7, 7) not in seen


def test_quantized_model_close_to_its_float_path(pair):
    """Correlation > 0.98, the bar of tests/test_quant.py: int8 error
    compounds across the convs."""
    _, _, tmodel = pair
    x = torch.from_numpy(_input("fused_uint8"))
    with torch.no_grad():
        fcls, _ = tmodel(x, enable_act=False)
        qcls, qreg = tq.quantized_apply(tmodel)(x, enable_act=False)
    assert torch.isfinite(qcls).all() and torch.isfinite(qreg).all()
    assert np.corrcoef(fcls.numpy().ravel(), qcls.numpy().ravel())[0, 1] > 0.98


def test_quantized_apply_keeps_the_model_and_its_weights(pair):
    _, v, tmodel = pair
    keys = list(tmodel.state_dict())
    fn = tq.quantized_apply(tmodel)
    with torch.no_grad():
        fn(torch.from_numpy(_input("rgb", n=1)), enable_act=False)
    assert list(tmodel.state_dict()) == keys
    load_jax_variables(tmodel, v)          # the bridge maps onto it as before


@pytest.mark.parametrize("nms_impl", ["pallas_fp", "iterative"])
def test_quantized_predict_matches_jax(pair, nms_impl):
    jmodel, v, tmodel = pair
    kw = dict(pre_nms_topk=256, max_detections=40, score_thresh=0.05,
              nms_impl=nms_impl, quantize=True)
    x = _input("fused_uint8", seed=31)
    want = j_make_predict(jmodel, JPredictConfig(**kw))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    got = make_predict_fn(tmodel, PredictConfig(**kw))(torch.from_numpy(x))
    assert np.asarray(want.valid).sum() > 0
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-3)


def test_float_and_quantized_predict_side_by_side(pair):
    """One model, two predict functions: alternated, and run at once from
    two threads, each gives what it gives alone (the int8 switch is per
    call and per thread, not a flag on the model)."""
    _, _, tmodel = pair
    kw = dict(pre_nms_topk=256, max_detections=40, nms_impl="pallas_fp")
    fpred = make_predict_fn(tmodel, PredictConfig(**kw))
    qpred = make_predict_fn(tmodel, PredictConfig(quantize=True, **kw))
    x = torch.from_numpy(_input("fused_uint8", seed=33))
    f_alone, q_alone = fpred(x), qpred(x)
    assert not torch.equal(f_alone.scores, q_alone.scores)
    assert int(q_alone.valid.sum()) > 0

    def same(a, b):
        return all(torch.equal(s, t) for s, t in zip(a, b))

    assert same(qpred(x), q_alone) and same(fpred(x), f_alone) and same(qpred(x), q_alone)
    got = {}

    def run(name, fn):
        got[name] = [fn(x) for _ in range(3)]

    threads = [threading.Thread(target=run, args=("q", qpred)),
               threading.Thread(target=run, args=("f", fpred))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert all(same(d, q_alone) for d in got["q"])
    assert all(same(d, f_alone) for d in got["f"])
