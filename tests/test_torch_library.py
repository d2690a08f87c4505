"""The kernels as ``torch.library`` operators (``ops/library.py``) on the
CPU: each operator's CPU implementation is its wrapper's plain version,
``torch.library.opcheck`` passes (schema, fake implementation, autograd
registration, AOT dispatch), and ``torch.export`` of each wrapper traces
to its operator and runs it back to the same bytes."""
import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch.ops import int8_matmul as im
from cl_object_detection_tpu_torch.ops import library
from cl_object_detection_tpu_torch.ops import nms as tn
from cl_object_detection_tpu_torch.ops import nms_fp as nf
from cl_object_detection_tpu_torch.ops import stem_fused as sf

torch.set_num_threads(1)


def _stem_args(dtype=torch.float32, seed=0):
    r = np.random.RandomState(seed)
    x4 = np.zeros((2, 8, 12, 64), np.float32)
    x4[..., :48] = r.randn(2, 8, 12, 48)
    k7 = torch.from_numpy((r.randn(7, 7, 3, 64) * 0.05).astype(np.float32))
    bias4 = torch.from_numpy((r.randn(256) * 0.1).astype(np.float32))
    return torch.from_numpy(x4).to(dtype), k7, bias4


def _nms_args(seed=0, b=2, k=64):
    r = np.random.RandomState(seed)
    boxes = r.rand(b, k, 4).astype(np.float32) * 50
    boxes[..., 2:] = boxes[..., :2] + 5 + r.rand(b, k, 2).astype(np.float32) * 20
    scores = np.sort(r.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    scores[:, k - 8:] = 0.0
    return torch.from_numpy(boxes), torch.from_numpy(scores)


def _int8_args(seed=0, m=40, k=72, n=24, bias=True):
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randint(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(r.randint(-127, 128, (n, k)).astype(np.int8))
    scale = torch.from_numpy((r.rand(n) * 1e-3).astype(np.float32))
    b = torch.from_numpy(r.randn(n).astype(np.float32)) if bias else None
    return x, w, scale, b


def _conv_args(seed=0, c=16, n=8):
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randint(-127, 128, (2, 7, 9, c)).astype(np.int8))
    w = torch.from_numpy(r.randint(-127, 128, (n, 9 * c)).astype(np.int8))
    scale = torch.from_numpy((r.rand(n) * 1e-3).astype(np.float32))
    return x, w, scale, torch.from_numpy(r.randn(n).astype(np.float32))


# (name, operator, args, plain version of the same call)
def _cases():
    x4, k7, b4 = _stem_args()
    x4h = x4.to(torch.bfloat16)
    k3 = sf.pack_stem_kernel(k7)
    boxes, scores = _nms_args()
    x, w, s, b = _int8_args()
    xc, wc, sc, bc = _conv_args()
    return [
        ("stem_fused_bf16", library.stem_fused_bf16, (x4h, k3.to(torch.bfloat16), b4),
         lambda: sf.stem_fused_reference(x4h, k3.to(torch.bfloat16), b4)),
        ("stem_fused_f32", library.stem_fused_f32, (x4, k7, b4),
         lambda: sf.stem_fused_reference(x4, k3, b4)),
        ("nms_fp", library.nms_fp, (boxes, scores, 0.5),
         lambda: nf.nms_fp_reference(boxes, scores, 0.5)),
        ("nms_iterative", library.nms_iterative, (boxes, scores, 0.5),
         lambda: tn.nms_iterative(boxes, scores, 0.5)),
        ("int8_matmul", library.int8_matmul, (x, w, s, b, torch.bfloat16),
         lambda: im.int8_matmul_reference(x, w, s, b, torch.bfloat16)),
        ("int8_matmul_f32_nobias", library.int8_matmul, (x, w, s, None, torch.float32),
         lambda: im.int8_matmul_reference(x, w, s, None, torch.float32)),
        ("int8_conv_nhwc", library.int8_conv_nhwc, (xc, wc, sc, bc, 3, 2, 1, torch.bfloat16),
         lambda: im.int8_conv_nhwc_reference(xc, wc, sc, bc, kernel=3, stride=2, padding=1,
                                             out_dtype=torch.bfloat16)),
    ]


CASES = {c[0]: c for c in _cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_impl_is_the_plain_version(name):
    _, op, args, plain = CASES[name]
    got = op(*args)
    want = plain()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_opcheck(name):
    _, op, args, _ = CASES[name]
    torch.library.opcheck(op, args)


def test_operators_are_registered_under_their_namespace():
    names = {"stem_fused_bf16", "stem_fused_f32", "nms_fp", "nms_iterative", "int8_matmul",
             "int8_conv_nhwc"}
    for name in names:
        assert hasattr(getattr(torch.ops, library.NAMESPACE), name), name


class _Call(torch.nn.Module):
    def __init__(self, fn, *consts):
        super().__init__()
        self.fn, self.consts = fn, consts

    def forward(self, x):
        return self.fn(x, *self.consts)


def _export_cases():
    x4, k7, b4 = _stem_args(seed=1)
    k3 = sf.pack_stem_kernel(k7)
    boxes, scores = _nms_args(seed=1)
    x, w, s, b = _int8_args(seed=1)
    xc, wc, sc, bc = _conv_args(seed=1)
    return {
        # the bfloat16 stem (the card's dtype) and the float32 one, which
        # carries its device-side check on k3 into the program
        "stem_fused_bf16": (lambda t: sf.stem_fused(t, k3.bfloat16(), b4), x4.bfloat16(),
                            {"stem_fused_bf16"}),
        "stem_fused_f32": (lambda t: sf.stem_fused(t, k3, b4), x4,
                           {"stem_fused_f32", "_assert_async"}),
        "stem_fused_f32_7x7": (lambda t: sf.stem_fused_f32(t, k7, b4), x4, {"stem_fused_f32"}),
        "nms_fp": (lambda t: nf.nms_fp(t, scores, 0.5), boxes, {"nms_fp"}),
        "int8_matmul": (lambda t: im.int8_matmul(t, w, s, b), x, {"int8_matmul"}),
        "int8_conv_nhwc": (lambda t: im.int8_conv_nhwc(t, wc, sc, bc, kernel=3, stride=1,
                                                        padding=1), xc, {"int8_conv_nhwc"}),
        "detect_batch_iterative": (
            lambda t: tn.detect_batch(t, torch.zeros(1, t.shape[1], 4),
                                      torch.from_numpy(_anchors()), height=64, width=64,
                                      pre_nms_topk=128, nms_impl="iterative",
                                      scores_are_logits=True).valid,
            torch.from_numpy(np.random.RandomState(3).randn(1, _anchors().shape[0], 3)
                             .astype(np.float32)),
            {"nms_iterative"}),
    }


def _anchors():
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape

    return anchors_for_shape(64, 64).copy()


EXPORT_CASES = _export_cases()


@pytest.mark.parametrize("name", list(EXPORT_CASES))
def test_export_of_the_wrapper_traces_to_the_operator(name):
    fn, x, ops = EXPORT_CASES[name]
    with torch.inference_mode():
        want = fn(x)
    program = torch.export.export(_Call(fn), (x,), strict=False)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    called = {t.split(".")[1] for t in targets if t.startswith(("cldet.", "aten._assert_async"))}
    assert called == ops, targets
    with torch.inference_mode():
        got = program.module()(x)
    assert torch.equal(got, want)


class _Stem(torch.nn.Module):
    def forward(self, x4, k3, bias4):
        return sf.stem_fused(x4, k3, bias4)


def test_float32_stem_check_survives_export():
    """A k3 that is not ``pack_stem_kernel``'s form trips the exported
    program's ``_assert_async`` (on the CPU at once; on the card at the
    next synchronise), and a packed one passes."""
    x4, k7, b4 = _stem_args(seed=2)
    k3 = sf.pack_stem_kernel(k7)
    program = torch.export.export(_Stem(), (x4, k3, b4), strict=False).module()
    bad = k3.clone()
    bad[0, 0, 60, 0] = 1.0                    # a pad channel: outside the 7x7 support
    with torch.inference_mode():
        assert torch.equal(program(x4, k3, b4), sf.stem_fused(x4, k3, b4))
        with pytest.raises(RuntimeError):
            program(x4, bad, b4)


def test_other_devices_find_no_kernel():
    """The wrappers refuse a device other than the CPU and the card, and
    the operators have no implementation for one."""
    x4, k7, b4 = _stem_args()
    with pytest.raises(ValueError, match="unsupported device"):
        sf.stem_fused(x4.to("meta"), sf.pack_stem_kernel(k7), b4)
    boxes, scores = _nms_args()
    with pytest.raises(ValueError, match="unsupported device"):
        nf.nms_fp(boxes.to("meta"), scores.to("meta"))
    x, w, s, b = _int8_args()
    with pytest.raises(ValueError, match="unsupported device"):
        im.int8_matmul(x.to("meta"), w.to("meta"), s.to("meta"))
