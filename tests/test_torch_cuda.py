"""The port's CUDA kernels against their plain versions on the card, at
shapes the main path does not give them: ragged stem tiles, a batch of
one, k that is not a multiple of 32, int8 GEMMs with ragged M, N and K
(every tile width and K split the kernel chooses), int8 convs with
ragged images, strides and paddings, NMS from k = 1 to 4096 with empty
and degenerate images, the stem's float32 form and its refusal of a
kernel that is not packed, and the wrappers' refusals. Then the train
path: the stem Function's backward on the card, gradients reaching the
stem's parameters through the kernel, one float32 apply on the card
against the same apply on the CPU, and a state-1 distillation micro-step
(student and teacher each through the stem kernel) against the CPU; the
IL passes of replay, prototypes and pseudo-labels (herding's feature
vectors, the prototype sums and the prototype loss with its gradient,
the pseudo-labels) against the CPU in float32; one MAS importance batch
and one A-GEM replay gradient against the CPU in float32. Then
evaluation: the ``Evaluator``
with the NMS kernel and with the iterative NMS gives the same rows, and
``detections_to_coco`` gives the same rows from card tensors as from
their CPU copies. Then the mesh's data axis: two gloo ranks on one card
all-reduce a gradient dict to the exact mean, a one-rank NCCL group runs
its collectives on the card, and two processes build every kernel at
once into an empty build directory.

Marked ``cuda``. Without a CUDA device every test skips: a kernel has no
CPU mode, and the CPU tests hold the plain versions to the JAX package.
On a machine with a card (the tests directory's conftest imports JAX,
which that machine need not have, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch.ops import int8_matmul as im
from cl_object_detection_tpu_torch.ops import nms as tn
from cl_object_detection_tpu_torch.ops import nms_fp as nf
from cl_object_detection_tpu_torch.ops import stem_fused as sf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _stem_inputs(dev, b, h4, w4, seed, dtype=torch.bfloat16):
    r = np.random.RandomState(seed)
    x4 = np.zeros((b, h4, w4, 64), np.float32)
    x4[..., :48] = r.randn(b, h4, w4, 48)
    k7 = (r.randn(7, 7, 3, 64) * 0.05).astype(np.float32)
    # 256 independent values: a kernel that reads another phase's bias fails
    bias4 = (r.randn(256) * 0.1).astype(np.float32)
    x = torch.from_numpy(x4).to(dev, dtype)
    k3 = sf.pack_stem_kernel(torch.from_numpy(k7).to(dev)).to(dtype)
    return x, k3, torch.from_numpy(bias4).to(dev)


def _bf16_ulp(x):
    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


STEM_SHAPES = [(1, 1, 1), (1, 37, 53), (2, 15, 15), (3, 16, 31), (2, 152, 208),
               # more units than SMs, and every ragged edge of the
               # kernel's 7 x 15 unit
               (5, 22, 29), (32, 152, 208),
               # the trainer's landscape and portrait frames (640 x 1024)
               (8, 160, 256), (8, 256, 160)]


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_kernel_matches_plain(dev, shape):
    """Within 2 bf16 ulps of the conv value before the bias: the kernel
    and cuDNN sum the 576 products in f32 in different orders, which can
    move the bf16 rounding of the conv output by one ulp."""
    x, k3, b4 = _stem_inputs(dev, *shape, seed=sum(shape))
    before = sf.stem_fused.launches
    got = sf.stem_fused(x, k3, b4)
    want = sf.stem_fused_reference(x, k3, b4)
    torch.cuda.synchronize()
    assert sf.stem_fused.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    tol = 2 * _bf16_ulp(want.float().abs() + b4.abs().max())
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_stem_kernel_takes_a_strided_view(dev):
    x, k3, b4 = _stem_inputs(dev, 2, 20, 24, seed=5)
    view = x[:, 2:18, 3:21]
    got = sf.stem_fused(view, k3, b4)
    want = sf.stem_fused(view.contiguous(), k3, b4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_f32_kernel_matches_plain(dev, monkeypatch, shape):
    """The float32 form against the plain version in float32 (TF32 off),
    rtol = atol = 1e-4: the kernel sums the 147 products of the 7x7 conv,
    the plain version the packed conv's 576 (429 of them zero) in another
    order, and cuDNN may transform the conv (Winograd, FFT) on the way.
    ``stem_fused`` on the packed kernel (checked on the device) and
    ``stem_fused_f32`` on the 7x7 kernel give the same bits."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, k3, b4 = _stem_inputs(dev, *shape, seed=sum(shape), dtype=torch.float32)
    before = (sf.stem_fused.launches, sf.stem_fused_f32.launches)
    got = sf.stem_fused(x, k3, b4)
    want = sf.stem_fused_reference(x, k3, b4)
    torch.cuda.synchronize()
    assert (sf.stem_fused.launches, sf.stem_fused_f32.launches) == (before[0], before[1] + 1)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(sf.stem_fused_f32(x, sf.unpack_stem_kernel(k3), b4), got)


_OFF_SUPPORT_SCRIPT = """
import torch
from cl_object_detection_tpu_torch.ops import stem_fused as sf
g = torch.Generator().manual_seed(0)
k3 = sf.pack_stem_kernel(torch.randn(7, 7, 3, 64, generator=g) * 0.05).cuda()
k3[0, 0, 0, 0] = 0.5          # tap row -1 of phase (0, 0): outside the 7x7 support
x = torch.randn(1, 8, 16, 64, generator=g).cuda()
out = sf.stem_fused(x, k3, torch.zeros(256, device="cuda"))
torch.cuda.synchronize()
print("RETURNED", float(out.sum()))
"""


def test_stem_f32_refuses_unpacked_kernel_on_the_card(dev):
    """A float32 ``stem_fused`` with a k3 that has a non-zero entry outside
    the 7x7 support (which the float32 form would drop) fails on the
    device, in a process of its own since a device-side assert ends the
    CUDA context: no result comes back."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _OFF_SUPPORT_SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "RETURNED" not in proc.stdout
    assert "assert" in proc.stderr.lower()


def test_stem_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """float16 has no kernel: TypeError (float32 has its own form, counted
    apart from the bf16 kernel). A wrong shape raises, and so does the
    packed kernel handed to the float32 form."""
    x, k3, b4 = _stem_inputs(dev, 1, 8, 8, seed=6)
    before = (sf.stem_fused.launches, sf.stem_fused_f32.launches)
    with pytest.raises(TypeError):
        sf.stem_fused(x.half(), k3, b4)
    with pytest.raises(TypeError):
        sf.stem_fused_f32(x, k3, b4)
    with pytest.raises(ValueError):             # the float32 form takes the 7x7 kernel
        sf.stem_fused_f32(x.float(), k3.float(), b4)
    with pytest.raises(ValueError):
        sf.stem_fused(x[..., :48], k3, b4)
    with pytest.raises(ValueError):
        sf.stem_fused(x[..., :48].float(), k3, b4)
    assert (sf.stem_fused.launches, sf.stem_fused_f32.launches) == before
    got = sf.stem_fused(x.float(), k3, b4)
    assert got.dtype == torch.float32
    assert (sf.stem_fused.launches, sf.stem_fused_f32.launches) == (before[0], before[1] + 1)


def test_fp32_fused_stem_model_runs_on_the_card(dev, monkeypatch):
    """ModelConfig(compute_dtype="float32") on 4x4 space-to-depth frames:
    the fused stem launches the kernel's float32 form once, and the
    forward equals the RGB-stem forward (TF32 off) at the CPU bar of
    tests/test_torch_stem.py, rtol = atol = 2e-4."""
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _, model = _small_model("float32")
    img = np.random.RandomState(13).randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    fused = torch.from_numpy(space_to_depth(img, factor=4)).to(dev)
    before = (sf.stem_fused.launches, sf.stem_fused_f32.launches)
    with torch.inference_mode():
        f_cls, f_reg = model(fused, enable_act=False)
        r_cls, r_reg = model(torch.from_numpy(img).to(dev), enable_act=False)
    torch.cuda.synchronize()
    assert (sf.stem_fused.launches, sf.stem_fused_f32.launches) == (before[0], before[1] + 1)
    assert f_cls.dtype == torch.float32
    for got, want in ((f_cls, r_cls), (f_reg, r_reg)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _nms_inputs(b, k, seed, near_threshold=False):
    r = np.random.RandomState(seed)
    bb = r.rand(b, k, 4).astype(np.float32) * 300
    bb[..., 2:] = bb[..., :2] + 10 + r.rand(b, k, 2).astype(np.float32) * 60
    ss = np.sort(r.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    ss[:, int(k * 0.9):] = 0.0
    if near_threshold:
        # pairs at IoU exactly 0.5: [x, x+2] vs [x+2/3, x+2+2/3], height 1
        xs = r.rand(b, k // 2).astype(np.float32) * 200
        zero = np.zeros_like(xs)
        bb[:, 0:k // 2 * 2:2] = np.stack([xs, zero, xs + 2, zero + 1], -1)
        sh = np.float32(2.0 / 3.0)
        bb[:, 1:k // 2 * 2:2] = bb[:, 0:k // 2 * 2:2] + [sh, 0, sh, 0]
    return bb, ss


@pytest.mark.parametrize("b", [1, 5, 32])
@pytest.mark.parametrize("k", [1, 31, 33, 200, 1000, 1024, 1300, 2048, 4096])
@pytest.mark.parametrize("near_threshold", [False, True])
def test_nms_kernel_bit_identical_to_plain(dev, b, k, near_threshold):
    """Keep masks bit-identical to nms_iterative on the card (and to the
    sequential nms_padded on the CPU where that is quick), one counted
    call each: k below, at and off multiples of 32 and of the mask
    kernel's 64-row blocks, past one 128-word scan tile (4096)."""
    bb, ss = _nms_inputs(b, k, seed=b * k + near_threshold, near_threshold=near_threshold)
    boxes, scores = torch.from_numpy(bb).to(dev), torch.from_numpy(ss).to(dev)
    before = nf.nms_fp.launches
    got = nf.nms_fp(boxes, scores, 0.5)
    torch.cuda.synchronize()
    assert nf.nms_fp.launches == before + 1
    want = nf.nms_fp_reference(boxes, scores, 0.5)
    assert got.dtype == torch.bool and got.shape == (b, k)
    assert torch.equal(got, want)
    if b * k <= 5000:
        assert torch.equal(got.cpu(), tn.nms_padded(torch.from_numpy(bb), torch.from_numpy(ss), 0.5))


@pytest.mark.parametrize("k", [33, 1024, 2048])
def test_nms_kernel_empty_and_identical_images(dev, k):
    """An image with no valid box keeps nothing, an image of identical
    boxes keeps its first, beside a random image, bit-identical to
    nms_iterative."""
    bb, ss = _nms_inputs(3, k, seed=k)
    ss[0] = 0.0                                         # all invalid
    bb[1] = np.array([10, 10, 50, 50], np.float32)      # identical boxes
    ss[1] = np.linspace(1.0, 0.5, k).astype(np.float32)
    boxes, scores = torch.from_numpy(bb).to(dev), torch.from_numpy(ss).to(dev)
    got = nf.nms_fp(boxes, scores, 0.5)
    want = tn.nms_iterative(boxes, scores, 0.5)
    assert torch.equal(got, want)
    assert int(got[0].sum()) == 0 and int(got[1].sum()) == 1 and bool(got[1, 0])


@pytest.mark.parametrize("topk", [512, 1000, 200, 2048])
def test_detect_batch_pallas_fp_equals_iterative_on_the_card(dev, topk):
    """pallas_fp launches the kernel at every k, not only at multiples of
    256."""
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape

    h, w = 128, 192
    anchors = torch.from_numpy(anchors_for_shape(h, w).copy()).to(dev)
    r = np.random.RandomState(3)
    a = anchors.shape[0]
    cls = torch.from_numpy((r.randn(4, a, 5) * 2 - 2).astype(np.float32)).to(dev)
    reg = torch.from_numpy(((r.rand(4, a, 4) - 0.5) * 0.4).astype(np.float32)).to(dev)
    kw = dict(height=h, width=w, pre_nms_topk=topk, max_detections=100,
              scores_are_logits=True)
    before = nf.nms_fp.launches
    got = tn.detect_batch(cls, reg, anchors, nms_impl="pallas_fp", **kw)
    assert nf.nms_fp.launches == before + 1
    want = tn.detect_batch(cls, reg, anchors, nms_impl="iterative", **kw)
    assert int(want.valid.sum()) > 0
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def _int8(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)


def _epilogue_inputs(dev, n, with_bias, seed):
    r = np.random.RandomState(seed)
    scale = torch.from_numpy((r.rand(n) * 1e-4).astype(np.float32)).to(dev)
    bias = torch.from_numpy(r.randn(n).astype(np.float32)).to(dev) if with_bias else None
    return scale, bias


GEMM_M = (1, 17, 64, 1000, 4160)
GEMM_K = (16, 288, 2304, 18432)
GEMM_N = (64, 128, 200, 256, 512)


@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("k", GEMM_K)
@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernel_bit_identical_to_plain(dev, m, k, n, with_bias, out_dtype):
    """Bit-identical: the int32 sum is exact on both sides (split K adds
    exact int32 partial sums), and the epilogue rounds the same f32 steps
    (the kernel never fuses them)."""
    seed = m * 7 + k + n
    x, w = _int8(dev, (m, k), seed), _int8(dev, (n, k), seed + 1)
    scale, bias = _epilogue_inputs(dev, n, with_bias, seed)
    before = im.int8_matmul.launches
    got = im.int8_matmul(x, w, scale, bias, out_dtype)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 1
    want = im.int8_matmul_reference(x, w, scale, bias, out_dtype)
    assert got.shape == (m, n) and got.dtype == out_dtype
    assert torch.equal(got, want)


# (B, H, W, C, N, kernel, stride, padding): one pixel, ragged odd images,
# every tile width (256 at the P5-sized shape), C = 16..2048 (K split at
# the fpn.p6 shape), 1x1 and 5x5 kernels, and a strided layer2 3x3 of the
# R50 at 608x832 (B=4). With the GEMM grid above, they run every tile
# plan (tests/test_torch_int8_conv.py checks the cover).
CONV_SHAPES = [
    (1, 1, 1, 16, 8, 3, 1, 1),
    (2, 7, 9, 16, 24, 3, 1, 1),
    (2, 7, 9, 32, 64, 3, 2, 1),
    (1, 13, 11, 64, 130, 3, 2, 0),
    (3, 5, 6, 48, 256, 3, 1, 0),
    (2, 19, 26, 2048, 256, 3, 2, 1),
    (2, 9, 7, 16, 40, 1, 2, 0),
    (1, 8, 8, 16, 16, 1, 1, 1),
    (1, 9, 9, 16, 32, 5, 2, 2),
    (2, 76, 104, 32, 256, 3, 1, 1),
    (4, 152, 208, 128, 128, 3, 2, 1),
]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_conv_kernel_bit_identical_to_plain(dev, shape, with_bias, out_dtype):
    """Conv mode against im2col + the plain GEMM, bit for bit."""
    b, h, w, c, n, ksize, stride, pad = shape
    seed = sum(shape)
    x, wt = _int8(dev, (b, h, w, c), seed), _int8(dev, (n, ksize * ksize * c), seed + 1)
    scale, bias = _epilogue_inputs(dev, n, with_bias, seed)
    kw = dict(kernel=ksize, stride=stride, padding=pad, out_dtype=out_dtype)
    before = (im.int8_matmul.launches, im.int8_conv_nhwc.launches)
    got = im.int8_conv_nhwc(x, wt, scale, bias, **kw)
    torch.cuda.synchronize()
    assert (im.int8_matmul.launches, im.int8_conv_nhwc.launches) == (before[0] + 1, before[1] + 1)
    want = im.int8_conv_nhwc_reference(x, wt, scale, bias, **kw)
    assert got.shape == want.shape and got.dtype == out_dtype
    assert torch.equal(got, want)


def test_int8_conv_kernel_takes_a_view(dev):
    """A channels-last activation seen through an NHWC permute is what
    ops/quant.py hands the kernel; a sliced view is made contiguous."""
    x = _int8(dev, (2, 12, 10, 32), 4)
    wt = _int8(dev, (48, 9 * 32), 5)
    scale, bias = _epilogue_inputs(dev, 48, True, 6)
    view = x[:, 1:11, 2:9]
    kw = dict(kernel=3, stride=1, padding=1)
    assert torch.equal(im.int8_conv_nhwc(view, wt, scale, bias, **kw),
                       im.int8_conv_nhwc(view.contiguous(), wt, scale, bias, **kw))


def test_int8_conv_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 5, 5, 24, dtype=torch.int8, device=dev)
    w = torch.zeros(8, 9 * 24, dtype=torch.int8, device=dev)
    scale = torch.ones(8, device=dev)
    kw = dict(kernel=3, stride=1, padding=1)
    before = im.int8_conv_nhwc.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        im.int8_conv_nhwc(x, w, scale, **kw)
    with pytest.raises(TypeError):
        im.int8_conv_nhwc(x[..., :16].float(), w[:, :144], scale, **kw)
    with pytest.raises(ValueError):
        im.int8_conv_nhwc(x[..., :16], w, scale, **kw)
    with pytest.raises(TypeError):
        im.int8_conv_nhwc(x[..., :16], w[:, :144], scale, out_dtype=torch.float16, **kw)
    assert im.int8_conv_nhwc.launches == before


def test_int8_matmul_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros(4, 64, dtype=torch.int8, device=dev)
    w = torch.zeros(8, 64, dtype=torch.int8, device=dev)
    scale = torch.ones(8, device=dev)
    before = im.int8_matmul.launches
    with pytest.raises(TypeError):
        im.int8_matmul(x.float(), w, scale)
    with pytest.raises(TypeError):
        im.int8_matmul(x, w.float(), scale)
    with pytest.raises(TypeError):
        im.int8_matmul(x, w, scale, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        im.int8_matmul(x, w[:, :32], scale)
    assert im.int8_matmul.launches == before


def _small_cpu_model(dtype):
    import math

    from cl_object_detection_tpu_torch.config import ModelConfig
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

    gen = torch.Generator().manual_seed(11)
    cpu = create_retinanet(ModelConfig(depth=18, fpn_channels=32, head_layers=2,
                                       compute_dtype=dtype), 3, device="cpu", generator=gen)
    with torch.no_grad():
        for head in (cpu.classification_head, cpu.regression_head):
            w = head.output.weight
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w[0].numel()))
    return cpu


def _small_model(dtype):
    import copy

    cpu = _small_cpu_model(dtype)
    return cpu, copy.deepcopy(cpu).to("cuda")


@pytest.mark.parametrize("dtype,form", [("float32", "rgb"), ("bfloat16", "fused_uint8")])
def test_quantized_model_on_the_card_runs_only_the_kernel(dev, monkeypatch, dtype, form):
    """The quantized R18 on the card: every int8 conv launches the kernel
    (19 backbone + 8 FPN + 2 heads x 2 convs x 5 levels), 41 of them in
    conv mode (16 backbone + 5 FPN + 2 x 2 x 5 head 3x3 convs) and 6 in
    GEMM mode (3 downsample + 3 lateral 1x1 convs); neither im2col nor a
    plain version ever runs, and cuDNN runs only the float convs (the
    heads' 10 output convs, plus the RGB stem). In float32 it correlates > 0.999 with the
    same model quantized on the CPU (TF32 off). Not closer: the float
    parts sum in other orders, so a dynamic scale max|x|/127 moves by an
    ulp and values near a rounding boundary flip by a whole int8 step;
    on the small deep maps each flip is a large share of the norm. On an
    H100 the two agreed to 3e-7 through layer2 and to relative L2 2.9e-2
    on the logits, less than the int8 result's own distance from the
    float one (4.0e-2). In bf16 it correlates > 0.98 with its own float
    path."""
    import torch.nn.functional as F

    from cl_object_detection_tpu_torch.data.transforms import space_to_depth
    from cl_object_detection_tpu_torch.ops import quant as tq

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu_model, model = _small_model(dtype)
    r = np.random.RandomState(12)
    img = r.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    x = (img.astype(np.float32) / 255.0 - 0.45) / 0.225 if form == "rgb" else \
        space_to_depth(img, factor=4)
    x = torch.from_numpy(np.ascontiguousarray(x))

    def refuse(name):
        def fail(*a, **k):
            raise AssertionError(f"{name} ran on the card")
        return fail

    convs = []
    real_conv2d = F.conv2d
    for mod, name in ((im, "int8_matmul_reference"), (im, "int8_conv_nhwc_reference"),
                      (im, "im2col"), (tq, "im2col")):
        monkeypatch.setattr(mod, name, refuse(name))
    monkeypatch.setattr(F, "conv2d", lambda *a, **k: convs.append(1) or real_conv2d(*a, **k))
    before = (im.int8_matmul.launches, im.int8_conv_nhwc.launches)
    with torch.inference_mode():
        q_cls, q_reg = tq.quantized_apply(model)(x.to(dev), enable_act=False)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches - before[0] == 19 + 8 + 2 * 2 * 5
    assert im.int8_conv_nhwc.launches - before[1] == 16 + 5 + 2 * 2 * 5
    assert len(convs) == 10 + (form == "rgb")
    monkeypatch.undo()
    assert torch.isfinite(q_cls.float()).all() and torch.isfinite(q_reg.float()).all()
    with torch.inference_mode():
        if dtype == "float32":
            c_cls, c_reg = tq.quantized_apply(cpu_model)(x, enable_act=False)
            for got, want in ((q_cls, c_cls), (q_reg, c_reg)):
                assert np.corrcoef(got.cpu().numpy().ravel(),
                                   want.numpy().ravel())[0, 1] > 0.999
        else:
            f_cls, _ = model(x.to(dev), enable_act=False)
            corr = np.corrcoef(f_cls.float().cpu().numpy().ravel(),
                               q_cls.float().cpu().numpy().ravel())[0, 1]
            assert corr > 0.98


# ---------------------------------------------------------------- training

def test_stem_function_backward_bit_identical_to_plain_autograd(dev, monkeypatch):
    """The fused stem under autograd on (8,152,208,64) bf16: the forward
    launches the kernel, and the backward equals autograd through
    ``stem_fused_reference`` at the same (x4, k3, bias4, g) to the bit
    (deterministic cuDNN, so both runs pick the same algorithms)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    x, k3, b4 = _stem_inputs(dev, 8, 152, 208, seed=21)
    g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(22),
                    device=dev).to(torch.bfloat16)
    ins = [t.detach().clone().requires_grad_(True) for t in (x, k3, b4)]
    before = sf.stem_fused.launches
    out = sf.stem_fused(*ins)
    assert sf.stem_fused.launches == before + 1
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, g)
    ref_ins = [t.detach().clone().requires_grad_(True) for t in (x, k3, b4)]
    want = torch.autograd.grad(sf.stem_fused_reference(*ref_ins), ref_ins, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(got[1].float().abs().max()) > 0 and float(got[2].abs().max()) > 0


def _train_pieces(dtype, device):
    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig, ScheduleConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step

    model = _small_cpu_model(dtype).to(device)
    state = TrainState(model, make_optimizer(ScheduleConfig(lr=1e-4, every_iter=1), model))
    step = make_train_step(model, None, anchors_for_shape(64, 96), ILConfig(), FocalConfig(),
                           LossStatics(num_classes=3), StepStatics(every_iter=1, grad_clip=0.1))
    return state, step


def _train_batch(device):
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth

    r = np.random.RandomState(14)
    img = r.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    boxes = np.full((2, 4, 4), -1, np.float32)
    labels = np.full((2, 4), -1, np.int32)
    boxes[0, :2] = [[4, 6, 40, 44], [30, 10, 80, 50]]
    labels[0, :2] = [0, 2]
    boxes[1, 0], labels[1, 0] = [10, 20, 60, 60], 1
    return tuple(torch.from_numpy(a).to(device)
                 for a in (space_to_depth(img, factor=4), boxes, labels))


def test_train_micro_step_on_the_card_reaches_the_stem(dev):
    """bf16 micro-step on fused uint8 frames: the stem kernel runs once
    and conv1.weight, bn1.weight and bn1.bias get finite, non-zero
    gradients (the kernel's output carries the Function's grad_fn)."""
    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape

    state, _ = _train_pieces("bfloat16", dev)
    model = state.model
    before = (sf.stem_fused.launches, sf.stem_fused_f32.launches)
    total, _ = compute_losses(model, *_train_batch(dev),
                              torch.from_numpy(anchors_for_shape(64, 96).copy()).to(dev),
                              ILConfig(), FocalConfig(), LossStatics(num_classes=3))
    total.backward()
    torch.cuda.synchronize()
    assert (sf.stem_fused.launches, sf.stem_fused_f32.launches) == (before[0] + 1, before[1])
    assert torch.isfinite(total)
    bb = model.backbone
    for name, p in (("conv1.weight", bb.conv1.weight), ("bn1.weight", bb.bn1.weight),
                    ("bn1.bias", bb.bn1.bias)):
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and float(p.grad.abs().max()) > 0, name


def test_float32_apply_on_the_card_matches_the_cpu(dev, monkeypatch):
    """One every_iter=1 apply (clip 0.1, Adam) of the float32 R18 on fused
    frames, TF32 off, on the card (the stem's float32 form under grad)
    and on the CPU from the same weights: metrics at rtol 1e-4,
    gradients at |d| <= 1e-3 |g_cpu| + 1e-4 max|g_cpu| per leaf, and
    the parameter deltas within 1e-3 lr plus a float32 spacing of the
    parameter where |g_cpu| >= 1e-3 max|g_cpu| (Adam's first step takes
    smaller gradients to either sign), everywhere at most lr (1 + 1e-6)
    plus that spacing: the CPU tests' bars."""
    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    lr = 1e-4
    results = []
    for device in ("cpu", dev):
        state, step = _train_pieces("float32", device)
        p0 = {n: p.detach().cpu().numpy().copy() for n, p in state.model.named_parameters()}
        before = sf.stem_fused_f32.launches
        # the gradient the apply uses: a micro-step's backward without the apply
        total, _ = compute_losses(state.model, *_train_batch(device),
                                  torch.from_numpy(anchors_for_shape(64, 96).copy()).to(device),
                                  ILConfig(), FocalConfig(), LossStatics(num_classes=3))
        total.backward()
        grads = {n: p.grad.cpu().numpy().copy() for n, p in state.model.named_parameters()}
        state.model.zero_grad(set_to_none=True)
        state, metrics = step(state, *_train_batch(device))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            assert sf.stem_fused_f32.launches == before + 2
        p1 = {n: p.detach().cpu().numpy() for n, p in state.model.named_parameters()}
        results.append((grads, {k: float(v) for k, v in metrics.items()},
                        {k: p1[k] - p0[k] for k in p0}, p0))
    (g_cpu, m_cpu, d_cpu, p0), (g_dev, m_dev, d_dev, _) = results
    for k in m_cpu:
        assert m_dev[k] == pytest.approx(m_cpu[k], rel=1e-4), k
    for k, w in g_cpu.items():
        assert (np.abs(g_dev[k] - w) <= 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).all(), k
    for k, w in d_cpu.items():
        ulp = np.spacing(np.abs(p0[k]))
        g = np.abs(g_cpu[k])
        sel = g >= 1e-3 * g.max()
        assert (np.abs(d_dev[k] - w)[sel] <= (1e-3 * lr + ulp)[sel]).all(), k
        assert (np.abs(d_dev[k]) <= lr * (1 + 1e-6) + ulp).all(), k
    assert np.abs(d_dev["backbone.conv1.weight"]).max() > 0


def _state1_pieces(dtype, device):
    """A state-1 train step of the small R18: the teacher at 3 classes,
    the student at 5 with its own backbone, FPN and trunks and the
    ``mean`` expansion of the teacher's classifier; distillation and the
    classifier-similarity loss; every_iter=1, clip 0.1."""
    from cl_object_detection_tpu_torch.config import (FocalConfig, ILConfig, ModelConfig,
                                                      ScheduleConfig)
    from cl_object_detection_tpu_torch.il.losses import LossStatics
    from cl_object_detection_tpu_torch.models.expand import classifier_class_vectors
    from cl_object_detection_tpu_torch.models.expand import expand_classifier
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step

    teacher = _small_cpu_model(dtype)
    student = create_retinanet(ModelConfig(depth=18, fpn_channels=32, head_layers=2,
                                           compute_dtype=dtype), 5, device="cpu",
                               generator=torch.Generator().manual_seed(12))
    own = student.state_dict()
    sim = np.array([[0.6, 0.3, 0.1], [0.2, 0.5, 0.3]], np.float32)
    expanded = expand_classifier(teacher.state_dict(), 2, similarity=sim)
    student.load_state_dict({k: v if k.startswith("classification_head.output.") else own[k]
                             for k, v in expanded.items()})
    student, teacher = student.to(device), teacher.to(device)
    statics = LossStatics(num_classes=5, num_past_class=3, incremental=True, use_distill=True,
                          use_classifier_loss=True)
    state = TrainState(student, make_optimizer(ScheduleConfig(lr=1e-4, every_iter=1), student))
    step = make_train_step(student, teacher, anchors_for_shape(64, 96), ILConfig(),
                           FocalConfig(), statics,
                           StepStatics(every_iter=1, grad_clip=0.1, num_past_class=3,
                                       num_knowing_class=5))
    vectors = torch.from_numpy(classifier_class_vectors(teacher.state_dict())).to(device)
    return state, step, teacher, statics, vectors


def _state1_batch(device):
    """``_train_batch``'s frames with GT of the new classes 3 and 4 (and
    an old one)."""
    images, boxes, labels = _train_batch(device)
    labels = labels.clone()
    labels[0, :2] = torch.tensor([3, 0])
    labels[1, 0] = 4
    return images, boxes, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state1_distill_micro_step_on_the_card(dev, monkeypatch, dtype):
    """A state-1 distillation micro-step on fused uint8 frames launches the
    stem kernel twice (the student under autograd, the teacher under
    no_grad) and gives finite distillation and similarity terms. In
    float32 (TF32 off) the card's metrics and gradients are held to the
    CPU's at the CPU tests' bars: metrics at rtol 1e-4, gradients at
    |d| <= 1e-3 |g_cpu| + 1e-4 max|g_cpu| per leaf; the teacher gets no
    gradient."""
    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig
    from cl_object_detection_tpu_torch.il.losses import compute_losses
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    counter = sf.stem_fused_f32 if dtype == "float32" else sf.stem_fused
    results = []
    for device in (("cpu", dev) if dtype == "float32" else (dev,)):
        state, step, teacher, statics, vectors = _state1_pieces(dtype, device)
        batch = _state1_batch(device)
        total, metrics = compute_losses(
            state.model, *batch, torch.from_numpy(anchors_for_shape(64, 96).copy()).to(device),
            ILConfig(), FocalConfig(), statics, teacher=teacher, classifier_vectors=vectors)
        total.backward()
        grads = {n: p.grad.cpu().numpy().copy() for n, p in state.model.named_parameters()}
        assert all(p.grad is None for p in teacher.parameters())
        state.model.zero_grad(set_to_none=True)
        results.append(({k: float(v.detach()) for k, v in metrics.items()}, grads))
        if torch.device(device).type == "cuda":
            before = counter.launches
            for _ in range(2):
                state, m = step(state, *batch, classifier_vectors=vectors)
            torch.cuda.synchronize()
            assert counter.launches == before + 4
            for k in ("dist_feat_loss", "dist_reg_loss", "dist_cls_loss", "sim_loss",
                      "total_loss"):
                assert np.isfinite(float(m[k])), k
            assert float(m["sim_loss"]) > 0
    if dtype == "bfloat16":
        return
    (m_cpu, g_cpu), (m_dev, g_dev) = results
    assert set(m_cpu) == set(m_dev)
    for k in m_cpu:
        assert m_dev[k] == pytest.approx(m_cpu[k], rel=1e-4), k
    for k, w in g_cpu.items():
        assert (np.abs(g_dev[k] - w) <= 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).all(), k


# ----------------------------------------------------------- the trainer

@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    """The CPU trainer tests' toy set: 8 PNG images at 48x64, every third
    portrait, 5 classes; trained at scale 1 in 64x64 frames."""
    import os

    from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

    root = str(tmp_path_factory.mktemp("toy_cuda"))
    return make_toy_dataset(root, num_images=8, image_size=(48, 64), seed=2), \
        os.path.join(root, "images")


def _trainer(toy_dataset, workdir, device, dtype="float32", fused=False, every_iter=1,
             end_epoch=2):
    from cl_object_detection_tpu_torch import config as tcfg
    from cl_object_detection_tpu_torch.train.trainer import ILTrainer

    cfg = tcfg.TrainConfig(
        model=tcfg.ModelConfig(depth=18, fpn_channels=32, head_layers=2, compute_dtype=dtype),
        data=tcfg.DataConfig(batch_size=2, min_side=48, max_side=64, height=64, width=64,
                             max_boxes=8, num_workers=0, prefetch=0, fused_stem=fused,
                             transfer_dtype="uint8" if fused else "float32"),
        schedule=tcfg.ScheduleConfig(lr=1e-5, every_iter=every_iter),
        il=tcfg.ILConfig(scenario=("5",)),
        checkpoint_dir=str(workdir / "ckpt"), start_epoch=1, end_epoch=end_epoch,
        record=False)
    return ILTrainer(cfg, *toy_dataset, workdir=str(workdir), device=device)


def test_train_process_on_the_card_matches_the_cpu(dev, toy_dataset, tmp_path, monkeypatch):
    """Two epochs of the float32 R18 trainer (RGB frames, every_iter=1,
    lr 1e-5), TF32 off, on the card and on the CPU from the same initial
    weights, at the CPU trainer tests' bars: every micro-step's
    total_loss at rtol 1e-4. The element-wise parameters part within the
    first epoch (cuDNN's float32 convolutions sum in another order than
    the CPU's, and Adam's normalisation carries the difference where the
    first moment is a small remainder of gradients of either sign: 7e-3
    lr per apply at the stem's weight after 4 applies on an NVIDIA H100),
    so the CPU run is replayed micro-step by micro-step, and at each one
    the card's gradient of that batch at the CPU's parameters is held to
    the train step's gradient bar, |d| <= 1e-3 |g_cpu| + 1e-4 max|g_cpu|
    per leaf; after the first apply, where the runs have not parted, the
    card's parameters are held within 1e-3 lr plus a float32 spacing of
    the parameter where the first moment is at least 1e-3 of the leaf's
    largest. The replay ends bit-equal to the CPU run."""
    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
    from cl_object_detection_tpu_torch.train.loop import train_process

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = _trainer(toy_dataset, tmp_path / "cpu", "cpu")
    card = _trainer(toy_dataset, tmp_path / "card", dev)
    start = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    card.model.load_state_dict(start)
    train_process(cpu)
    train_process(card)
    np.testing.assert_allclose(np.asarray(card.loss_hist), np.asarray(cpu.loss_hist),
                               rtol=1e-4)
    assert all(np.isfinite(p.detach().cpu().numpy()).all() for p in card.model.parameters())

    ref = _trainer(toy_dataset, tmp_path / "ref", "cpu")
    probe = _trainer(toy_dataset, tmp_path / "probe", dev)
    ref.model.load_state_dict(start)
    probe.model.load_state_dict(start)
    init = {n: p.detach().numpy().copy() for n, p in ref.model.named_parameters()}
    anchors = torch.from_numpy(ref._anchors_at(64, 64).copy())
    lr, i = 1e-5, 0
    for epoch in (1, 2):
        ref.train_loader.set_epoch(epoch)
        ref.warm_up(epoch)
        ref.set_replay_beta(False)
        for b in ref.train_loader:
            if i:
                probe.model.load_state_dict(ref.model.state_dict())
            grads = []
            for tr, device in ((ref, "cpu"), (probe, dev)):
                tr.model.zero_grad(set_to_none=True)
                total, _ = compute_losses(
                    tr.model, *(torch.from_numpy(a).to(device)
                                for a in (b.images, b.boxes, b.labels)),
                    anchors.to(device), ILConfig(), FocalConfig(), LossStatics(num_classes=5))
                total.backward()
                grads.append({n: p.grad.cpu().numpy().copy()
                              for n, p in tr.model.named_parameters()})
                tr.model.zero_grad(set_to_none=True)
            for n, w in grads[0].items():
                d = np.abs(grads[1][n] - w)
                assert (d <= 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).all(), (i, n)
            ref.run_batch(b)
            if i == 0:
                probe.run_batch(b)
                names = {id(p): n for n, p in ref.model.named_parameters()}
                mu = {names[id(p)]: s["mu"].numpy() for p, s in ref.optimizer.state.items()}
                for n, p in probe.model.named_parameters():
                    d_dev = p.detach().cpu().numpy() - init[n]
                    d_cpu = ref.model.get_parameter(n).detach().numpy() - init[n]
                    m = np.abs(mu[n])
                    sel = m >= 1e-3 * m.max() if m.max() > 0 else np.zeros_like(m, bool)
                    tol = 1e-3 * lr + np.spacing(np.abs(init[n]))
                    assert not (sel & (np.abs(d_dev - d_cpu) > tol)).any(), n
            i += 1
        ref.step_scheduler(epoch)
    assert i == len(cpu.loss_hist) == 8
    for n, p in cpu.model.named_parameters():
        assert torch.equal(ref.model.get_parameter(n), p), n


def test_bf16_fused_trainer_launches_the_stem_every_micro_step(dev, toy_dataset, tmp_path):
    from cl_object_detection_tpu_torch.train.loop import train_process

    tr = _trainer(toy_dataset, tmp_path, dev, dtype="bfloat16", fused=True, every_iter=2)
    before = (sf.stem_fused.launches, sf.stem_fused_f32.launches, nf.nms_fp.launches,
              im.int8_matmul.launches)
    train_process(tr)
    torch.cuda.synchronize()
    steps = len(tr.loss_hist)
    assert steps == tr.train_state.step == 8
    assert sf.stem_fused.launches == before[0] + steps
    assert (sf.stem_fused_f32.launches, nf.nms_fp.launches, im.int8_matmul.launches) \
        == before[1:]
    assert np.isfinite(np.asarray(tr.loss_hist)).all()


def test_checkpoint_saved_on_the_card_restores_bit_for_bit(dev, toy_dataset, tmp_path):
    """An async save of a trained model and optimizer on the card, then a
    fresh trainer's resume: every tensor equal, on the card."""
    from cl_object_detection_tpu_torch.train.loop import train_process

    tr = _trainer(toy_dataset, tmp_path, dev, dtype="bfloat16", fused=True, end_epoch=1)
    train_process(tr)
    model = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt = tr.optimizer.state_dict()
    fresh = _trainer(toy_dataset, tmp_path, dev, dtype="bfloat16", fused=True, end_epoch=1)
    assert fresh.resume(0, 1) == 1
    for k, v in fresh.model.state_dict().items():
        assert v.device.type == "cuda" and torch.equal(v, model[k]), k
    got = fresh.optimizer.state_dict()
    assert got["param_groups"] == opt["param_groups"]
    for i, st in opt["state"].items():
        for m in ("mu", "nu"):
            assert got["state"][i][m].device.type == "cuda"
            assert torch.equal(got["state"][i][m], st[m]), (i, m)


# --------------------------------------- replay, prototypes, pseudo-labels

def _tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def test_herding_features_on_the_card_match_the_cpu(dev, monkeypatch):
    """``il.herding.make_feature_fn`` of the small float32 R18 on fused
    uint8 frames, TF32 off: one launch of the stem kernel's float32 form,
    and the vectors within 1e-5 of the CPU's largest |value| (chip_smoke
    phase 11's bar)."""
    from cl_object_detection_tpu_torch.il import herding

    _tf32_off(monkeypatch)
    cpu, card = _small_model("float32")
    images = _train_batch(dev)[0]
    before = sf.stem_fused_f32.launches
    got = herding.make_feature_fn(card)(images).cpu().numpy()
    torch.cuda.synchronize()
    assert sf.stem_fused_f32.launches == before + 1
    want = herding.make_feature_fn(cpu)(images.cpu()).numpy()
    assert got.shape == want.shape == (2, sum(n * n for n in herding.FEATURE_SIZES) * 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_prototype_sums_and_loss_on_the_card_match_the_cpu(dev, monkeypatch):
    """The prototype pass of one batch (``make_batch_prototype_fn``: sums
    and counts over the positive anchors) and ``prototype_loss_from_batch``
    of its unfolded features (class 0 old, classes 1 and 2 new) with its
    gradient, on the card and on the CPU in float32, TF32 off: counts
    equal, sums within 1e-5 of the largest |value|, the loss at rtol
    1e-4, its gradient within 1e-4 of the largest |value|."""
    from cl_object_detection_tpu_torch.il import prototype
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.ops.boxes import positive_assignment

    _tf32_off(monkeypatch)
    out = []
    for model, device in zip(_small_model("float32"), ("cpu", dev)):
        images, boxes, labels = _train_batch(device)
        anchors = torch.from_numpy(anchors_for_shape(64, 96).copy()).to(device)
        sums, counts = prototype.make_batch_prototype_fn(model, 3)(anchors, images, boxes,
                                                                    labels)
        with torch.no_grad():
            unfolded = model.classification_features(images)[3]
        pos, lab = zip(*(positive_assignment(anchors, b, l) for b, l in zip(boxes, labels)))
        unfolded.requires_grad_(True)
        old = (sums[:1] / counts[:1, :, None].clamp(min=1)).mean(dim=1)
        loss = prototype.prototype_loss_from_batch(unfolded, torch.stack(pos), torch.stack(lab),
                                                   old, num_past_class=1, num_new_class=2)
        loss.backward()
        out.append([t.detach().cpu().numpy() for t in (sums, counts, loss, unfolded.grad)])
    (s_c, c_c, l_c, g_c), (s_d, c_d, l_d, g_d) = out
    assert c_c.sum() > 0 and np.array_equal(c_c, c_d)
    assert np.abs(s_d - s_c).max() <= 1e-5 * np.abs(s_c).max()
    assert float(l_c) > 0 and float(l_d) == pytest.approx(float(l_c), rel=1e-4)
    assert np.abs(g_d - g_c).max() <= 1e-4 * np.abs(g_c).max()


def _assert_grads_close(got: dict, want: dict):
    """The train step's gradient bar: |d| <= 1e-3 |g_cpu| + 1e-4 max|g_cpu|
    per leaf."""
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach().cpu().numpy()
        w = w.detach().numpy()
        bad = np.abs(g - w) > 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()
        assert not bad.any(), (name, int(bad.sum()), float(np.abs(g - w).max()))


def test_mas_importance_and_agem_replay_grad_on_the_card_match_the_cpu(dev, monkeypatch):
    """One MAS importance batch (``il.mas.make_importance_step``: |grad| of
    the output norm) and one A-GEM replay gradient (``il.agem.AGem`` over
    one batch: clipped, BN leaves zeroed) of the small float32 R18 on
    fused uint8 frames, TF32 off, on the card (the stem kernel's float32
    form under grad, one launch each) and on the CPU: every leaf at the
    gradient bar, the importance nonzero on every leaf MAS keeps, the BN
    leaves of the replay gradient zero, the parameters' ``.grad``
    untouched."""
    from types import SimpleNamespace

    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig
    from cl_object_detection_tpu_torch.il import agem, mas
    from cl_object_detection_tpu_torch.il.losses import LossStatics
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape

    _tf32_off(monkeypatch)
    anchors = anchors_for_shape(64, 96)
    out = []
    for model, device in zip(_small_model("float32"), ("cpu", dev)):
        images, boxes, labels = _train_batch(device)
        before = sf.stem_fused_f32.launches
        imp = mas.make_importance_step(model)(torch.from_numpy(anchors.copy()).to(device),
                                              images, boxes, labels)
        batch = SimpleNamespace(images=images.cpu().numpy(), boxes=boxes.cpu().numpy(),
                                labels=labels.cpu().numpy())
        statics = LossStatics(num_classes=3, num_past_class=2, is_replay=True)
        replay = agem.AGem(model, anchors, ILConfig(), FocalConfig(), statics,
                           [batch]).compute_replay_grad()
        if device != "cpu":
            torch.cuda.synchronize()
            assert sf.stem_fused_f32.launches == before + 2
        assert all(p.grad is None for p in model.parameters())
        out.append((imp, replay))
    (imp_c, rep_c), (imp_d, rep_d) = out
    _assert_grads_close(imp_d, imp_c)
    _assert_grads_close(rep_d, rep_c)
    mask = mas.importance_mask(imp_c)
    assert all(float(v.abs().max()) > 0 for k, v in imp_c.items() if mask[k].all())
    assert not rep_d["backbone.bn1.weight"].any()


def test_pseudo_labels_on_the_card_match_the_cpu(dev, toy_dataset, monkeypatch):
    """``generate_pseudo_labels`` of a 3-class float32 teacher with random
    output convs (logit std near 1, bias -2) over the state-1 images of
    scenario 3+2 (fused uint8 frames), TF32 off, threshold 0.2: on the
    card and on the CPU the same images, counts and classes, boxes within
    1e-3 px (chip_smoke phase 11's bar), and labels to keep."""
    import copy

    from cl_object_detection_tpu_torch.config import DataConfig, PseudoLabelConfig
    from cl_object_detection_tpu_torch.data.coco import CocoJson
    from cl_object_detection_tpu_torch.data.dataset import ILDataset
    from cl_object_detection_tpu_torch.il.pseudo_label import generate_pseudo_labels
    from cl_object_detection_tpu_torch.states import ILStates

    _tf32_off(monkeypatch)
    json_path, images = toy_dataset
    coco = CocoJson(json_path)
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, ["3", "2"])
    ds = ILDataset(coco, states, images, split="train", start_state=1)
    cfg = DataConfig(batch_size=2, min_side=48, max_side=64, height=64, width=64,
                     max_boxes=8, num_workers=0, prefetch=0, fused_stem=True,
                     transfer_dtype="uint8")
    card = _eval_model(dev, "float32", num_classes=3)
    got = {}
    for model in (card, copy.deepcopy(card).to("cpu")):
        got[next(model.parameters()).device.type] = generate_pseudo_labels(
            model, ds, cfg, PseudoLabelConfig(enabled=True, score_thresh=0.2),
            states.inverse_label_map())
    c, d = got["cpu"], got["cuda"]
    assert list(c) == list(d) == list(ds.image_ids)
    assert sum(len(a) for a in c.values()) > 0
    for img_id, anns in c.items():
        assert [a["category_id"] for a in d[img_id]] == [a["category_id"] for a in anns]
        for ga, ca in zip(d[img_id], anns):
            assert np.abs(np.subtract(ga["bbox"], ca["bbox"])).max() <= 1e-3


# ------------------------------------------------------------ evaluation

def _eval_model(dev, dtype, num_classes=5):
    """The small R18 with random output convs scaled as in
    tests/test_torch_eval.py (logit std near 1, bias -2), so that every
    image has detections at score_thresh 1e-3."""
    import math

    from cl_object_detection_tpu_torch.config import ModelConfig
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

    gen = torch.Generator().manual_seed(3)
    model = create_retinanet(ModelConfig(depth=18, fpn_channels=32, head_layers=2,
                                         compute_dtype=dtype), num_classes, device=dev,
                             generator=gen)
    with torch.no_grad():
        for head, std in ((model.classification_head, 1.0), (model.regression_head, 0.3)):
            w = head.output.weight
            w.copy_(torch.randn(w.shape, generator=gen).to(dev) / math.sqrt(w[0].numel()))
        x = torch.zeros(1, 32, 48, 64, dtype=torch.uint8, device=dev)
        x[..., :48] = torch.randint(0, 256, (1, 32, 48, 48), generator=gen).to(dev)
        cls, reg = model(x, enable_act=False)
        bias_c = model.classification_head.output.bias
        model.classification_head.output.weight.mul_(1.0 / float((cls - bias_c[0]).float().std()))
        bias_c.fill_(-2.0)
        model.regression_head.output.weight.mul_(0.3 / float(reg.float().std()))
    return model


def _eval_split(tmp_path, nms_impl):
    import os

    from cl_object_detection_tpu_torch.config import DataConfig, PredictConfig
    from cl_object_detection_tpu_torch.data.coco import CocoJson
    from cl_object_detection_tpu_torch.eval.evaluator import Evaluator
    from cl_object_detection_tpu_torch.states import ILStates
    from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

    root = str(tmp_path)
    if not os.path.exists(os.path.join(root, "test.json")):
        make_toy_dataset(root, num_images=12, image_size=(90, 120), seed=3, split="test")
    coco = CocoJson(os.path.join(root, "test.json"))
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, ["5"])
    data = DataConfig(batch_size=4, min_side=96, max_side=192, height=128, width=192,
                      max_boxes=8, num_workers=0, prefetch=0, fused_stem=True,
                      transfer_dtype="uint8")
    return Evaluator(coco, states, os.path.join(root, "images"), data,
                     PredictConfig(score_thresh=1e-3, nms_impl=nms_impl))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_evaluator_rows_equal_under_both_nms_on_the_card(dev, tmp_path, dtype):
    """The Evaluator on the card with the NMS kernel (``pallas_fp``) and
    with the iterative NMS: identical rows (the keep masks are
    bit-identical), the kernel launched once per batch."""
    model = _eval_model(dev, dtype)
    iterative = _eval_split(tmp_path, "iterative")
    kernel = _eval_split(tmp_path, "pallas_fp")
    before = nf.nms_fp.launches
    rows = kernel.predict_dataset(model)
    assert nf.nms_fp.launches == before + len(kernel.loader)
    want = iterative.predict_dataset(model)
    assert len(rows) > 12 * 50
    assert rows == want
    res = kernel.evaluate(rows)
    assert res.pred_num == len(rows) and np.isfinite(res.mean_ap50)


def test_detections_to_coco_from_the_card_equals_the_cpu_copy(dev):
    """Rows of detections lying on the card equal the rows of the same
    detections copied to the CPU."""
    from cl_object_detection_tpu_torch.eval.predictor import detections_to_coco

    g = torch.Generator(device=dev).manual_seed(5)
    b, d = 4, 300
    xy = torch.rand(b, d, 2, generator=g, device=dev) * 500
    boxes = torch.cat([xy, xy + 1 + torch.rand(b, d, 2, generator=g, device=dev) * 90], -1)
    det = tn.Detections(boxes=boxes, scores=torch.rand(b, d, generator=g, device=dev),
                        labels=torch.randint(0, 20, (b, d), generator=g, device=dev,
                                             dtype=torch.int32),
                        valid=torch.rand(b, d, generator=g, device=dev) > 0.1)

    class Batch:
        image_ids = np.array([3, 8, -1, 11])
        scales = np.array([0.75, 1.6, 1.0, 1.0 / 3.0], np.float32)

    label_to_cat = {i: i + 1 for i in range(20)}
    got = detections_to_coco(det, Batch, label_to_cat, 0.05, keep_slots=[True, True, True, False])
    want = detections_to_coco(tn.Detections(*(t.cpu() for t in det)), Batch, label_to_cat, 0.05,
                              keep_slots=[True, True, True, False])
    assert len(got) > 400
    assert got == want


# ---------------------------------------------------------------- export

def _op_calls(dev):
    """(name, operator call, direct launch, its counter) of each kernel
    operator at a small shape on the card."""
    from cl_object_detection_tpu_torch.ops import library

    x, k3, b4 = _stem_inputs(dev, 2, 37, 53, seed=21)
    xf, k3f, _ = _stem_inputs(dev, 2, 37, 53, seed=22, dtype=torch.float32)
    k7 = sf.unpack_stem_kernel(k3f)
    boxes, scores = (t.to(dev) for t in _nms_case(3, 1000, seed=23))
    r = np.random.RandomState(24)
    a = torch.from_numpy(r.randint(-127, 128, (300, 576)).astype(np.int8)).to(dev)
    w = torch.from_numpy(r.randint(-127, 128, (96, 576)).astype(np.int8)).to(dev)
    s = torch.from_numpy((r.rand(96) * 1e-3).astype(np.float32)).to(dev)
    bias = torch.from_numpy(r.randn(96).astype(np.float32)).to(dev)
    xq = torch.from_numpy(r.randint(-127, 128, (2, 19, 26, 64)).astype(np.int8)).to(dev)
    return [
        ("stem_fused_bf16", lambda: library.stem_fused_bf16(x, k3, b4),
         lambda: sf._launch_bf16(x, k3, b4), sf.stem_fused),
        ("stem_fused_f32", lambda: library.stem_fused_f32(xf, k7, b4),
         lambda: sf._launch_f32(xf, k7, b4), sf.stem_fused_f32),
        ("nms_fp", lambda: library.nms_fp(boxes, scores, 0.5),
         lambda: nf._launch(boxes, scores, 0.5), nf.nms_fp),
        ("int8_matmul", lambda: library.int8_matmul(a, w, s, bias, torch.bfloat16),
         lambda: im._launch_gemm(a, w, s, bias, torch.bfloat16), im.int8_matmul),
        ("int8_conv_nhwc", lambda: library.int8_conv_nhwc(xq, w, s, bias, 3, 2, 1,
                                                          torch.float32),
         lambda: im._launch_conv(xq, w, s, bias, 3, 2, 1, torch.float32), im.int8_conv_nhwc),
    ]


def _nms_case(b, k, seed):
    r = np.random.RandomState(seed)
    boxes = r.rand(b, k, 4).astype(np.float32) * 600
    boxes[..., 2:] = boxes[..., :2] + 10 + r.rand(b, k, 2).astype(np.float32) * 60
    scores = np.sort(r.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("i", range(5))
def test_operator_on_the_card_equals_the_direct_launch(dev, i):
    """Each ``cldet`` operator's CUDA implementation launches the kernel
    once (its counter rises by one) and gives the bytes of the direct
    launch."""
    name, op, direct, counter = _op_calls(dev)[i]
    want = direct()
    before = counter.launches
    got = op()
    torch.cuda.synchronize()
    assert counter.launches == before + 1, name
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), name


@pytest.mark.parametrize("quantize", [False, True])
def test_exported_artifact_on_the_card_equals_live_predict(dev, tmp_path, monkeypatch, quantize):
    """An R18 (bf16, fused uint8 frames) exported on the card and loaded
    back: detections equal the live predict's bit for bit (deterministic
    cuDNN in both), and every predict of the artifact launches the stem
    kernel once (and, quantized, the int8 kernel 47 times, 41 in conv
    mode). The float one also carries a CPU program, which loads."""
    import json
    import os

    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth
    from cl_object_detection_tpu_torch.eval.deploy import (
        export_predict,
        load_artifact,
        load_serving_bundle,
        save_artifact,
    )
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
    from cl_object_detection_tpu_torch.utils.checkpoint import CheckpointManager

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cpu_model, _ = _small_model("bfloat16")
    ckpt = CheckpointManager(os.path.join(str(tmp_path), "checkpoint"), ["3"])
    ckpt.save(0, 1, cpu_model, torch.optim.SGD(cpu_model.parameters(), lr=0.1), 0,
              il_meta={"num_classes": 3})
    with open(os.path.join(ckpt.state_dir(0), "params.json"), "w") as f:
        json.dump({"model": {"depth": 18, "fpn_channels": 32, "head_layers": 2},
                   "data": {"height": 64, "width": 96, "fused_stem": True}}, f)
    bundle = load_serving_bundle(str(tmp_path), ["3"], 0)
    assert next(bundle.model.parameters()).device.type == "cuda"
    # the float artifact is exported for both device types, each traced
    # on its own device
    platforms = ["cuda"] if quantize else ["cuda", "cpu"]
    blobs, meta = export_predict(bundle, batch=2, score_thresh=0.0, quantize=quantize,
                                 platforms=platforms)
    assert meta["platforms"] == platforms and sorted(blobs) == sorted(platforms)
    save_artifact(str(tmp_path / "art"), blobs, meta)
    fn, _ = load_artifact(str(tmp_path / "art"))
    if not quantize:
        load_artifact(str(tmp_path / "art"), device="cpu")
    img = np.random.RandomState(25).randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    frames = space_to_depth(img, factor=4)
    before = (sf.stem_fused.launches, im.int8_matmul.launches, im.int8_conv_nhwc.launches)
    got = fn(frames)
    torch.cuda.synchronize()
    launches = (sf.stem_fused.launches - before[0], im.int8_matmul.launches - before[1],
                im.int8_conv_nhwc.launches - before[2])
    assert launches == ((1, 47, 41) if quantize else (1, 0, 0))
    det = make_predict_fn(bundle.model, PredictConfig(score_thresh=0.0, quantize=quantize))(
        torch.from_numpy(frames).to(dev))
    assert got["valid"].sum() > 0
    for k, v in zip(("boxes", "scores", "labels", "valid"), det):
        assert np.array_equal(got[k], v.cpu().numpy()), k


# ------------------------------------------------ the mesh's data axis

_REPO = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))

_SHARED_CARD_RANK = r"""
import os, sys
import torch
from cl_object_detection_tpu_torch.config import MeshConfig
from cl_object_detection_tpu_torch.parallel import mesh as pm
rank, store = int(sys.argv[1]), sys.argv[2]
dev = pm.init_distributed(num_processes=2, process_id=rank, init_method="file://" + store)
mesh = pm.create_mesh(MeshConfig(enabled=True), dev)
assert (mesh.backend, dev) == ("gloo", torch.device("cuda", 0)), (mesh.backend, dev)
gen = torch.Generator().manual_seed(rank)
grads = {k: torch.randn(shape, generator=gen).to(dev)
         for k, shape in (("w", (64, 3, 7, 7)), ("b", (64,)), ("s", ()))}
out = pm.all_reduce_grads(mesh, grads)
assert all(v.device == dev for v in out.values())
torch.save({"in": {k: v.cpu() for k, v in grads.items()},
            "out": {k: v.cpu() for k, v in out.items()}}, f"{store}.{rank}.pt")
pm.barrier(mesh)
"""


def _run_children(script, args_per_child, timeout=240, **env_extra):
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=_REPO, **env_extra)
    procs = [subprocess.Popen([sys.executable, "-c", script, *args], env=env, cwd=_REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for args in args_per_child]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_two_gloo_ranks_on_one_card_all_reduce_to_the_exact_mean(dev, tmp_path):
    """The process flags place two ranks on cuda:0 on purpose: gloo, the
    collectives through the host; the all-reduced gradient dict is the
    exact mean of the two ranks' on both, back on the card. (One card is
    made visible: on a host of two, the rule gives each rank its own.)"""
    store = str(tmp_path / "store")
    _run_children(_SHARED_CARD_RANK, [(str(r), store) for r in range(2)],
                  CUDA_VISIBLE_DEVICES="0")
    res = [torch.load(f"{store}.{r}.pt", weights_only=True) for r in range(2)]
    for k in res[0]["in"]:
        want = (res[0]["in"][k] + res[1]["in"][k]) / 2
        assert torch.equal(res[0]["out"][k], want) and torch.equal(res[1]["out"][k], want), k


_SPLIT_HEAD_RANK = r"""
import sys
import torch
from cl_object_detection_tpu_torch.config import MeshConfig, ModelConfig
from cl_object_detection_tpu_torch.models.heads import head_parallel
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.parallel import mesh as pm
from cl_object_detection_tpu_torch.utils import profiling
rank, store = int(sys.argv[1]), sys.argv[2]
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
dev = pm.init_distributed(num_processes=2, process_id=rank, init_method="file://" + store)
mesh = pm.create_mesh(MeshConfig(enabled=True, num_model=2), dev)
assert (mesh.backend, mesh.shape, mesh.model_index) == ("gloo", {"data": 1, "model": 2}, rank)
out = {}
for dtype in ("float32", "bfloat16"):
    model = create_retinanet(ModelConfig(depth=18, compute_dtype=dtype), 20, device=dev,
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for h in (model.regression_head, model.classification_head):
            w = h.output.weight
            w.copy_(0.01 * torch.randn(w.shape, generator=torch.Generator().manual_seed(1)))
    x = torch.randn(2, 256, 384, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    runs = []
    # whole, split, then whole again with every weight moved by -1, 0 or +1
    # float32 ulp (the rounding scale the split is held to in bfloat16)
    for split in (None, mesh, "moved"):
        if split == "moved":
            split = None
            gen = torch.Generator().manual_seed(3)
            with torch.no_grad():
                for p in model.parameters():
                    sign = torch.randint(-1, 2, p.shape, generator=gen).float().to(dev)
                    p.mul_(1 + sign * 2.0 ** -23)
        model.zero_grad(set_to_none=True)
        profiling.reset_counters()
        with head_parallel(model, split):
            cls, reg = model(x, enable_act=False)
        (cls.square().mean() + reg.square().mean()).backward()
        grads = pm.gather_model_grads(split, {n: p.grad for n, p in model.named_parameters()})
        trunk = [c.calls for n, c in profiling.counters().items()
                 if n in ("cldet.mesh.model_all_reduce", "cldet.mesh.model_all_gather")]
        runs.append(({"cls": cls.detach().cpu(), "reg": reg.detach().cpu()},
                     {n: g.cpu() for n, g in grads.items()}, sum(trunk)))
        if split is not None:
            reduced = {n: g.cpu() for n, g in pm.all_reduce_grads(mesh, grads).items()}
    out[dtype] = runs + [reduced]
torch.save(out, f"{store}.{rank}.pt")
pm.barrier(mesh)
"""


def test_split_head_on_two_gloo_ranks_of_one_card(dev, tmp_path):
    """The model axis on one card: two ranks (process flags, gloo) split an
    R18's head trunks (FPN 256, four layers) at 256 x 384, forward and
    backward, against the whole trunks on the same rank. float32 (TF32
    off): the outputs within 1e-5 of the tensor's largest (float32
    rounding), every gradient at the train step's bar (|d| <= 1e-3 |g| +
    1e-4 max|g|: the stem's weight gradient sums the rounding of a whole
    frame: 4.4e-5 of its largest on an H100). bfloat16 (the
    row-parallel sums rounded once per rank, then added): the outputs
    within 2e-2 of the tensor's largest, the gradients at phase 12's bar
    of chip_smoke.py (the larger of the gradient bar and twice the move
    that a one-ulp change of the weights gives the whole trunks'
    gradients). 40 collectives of the model group per pass; after
    ``all_reduce_grads`` both ranks hold the same bits (before it the
    replicated leaves' gradients may differ by the card's nondeterministic
    reductions)."""
    store = str(tmp_path / "store")
    _run_children(_SPLIT_HEAD_RANK, [(str(r), store) for r in range(2)],
                  CUDA_VISIBLE_DEVICES="0", timeout=600)
    res = [torch.load(f"{store}.{r}.pt", weights_only=True) for r in range(2)]

    def worst(got, want):
        # the largest |d| / (1e-3 |g| + 1e-4 max|g|) over every leaf
        return max(float(((got[k] - w).abs() / (1e-3 * w.abs() + 1e-4 * w.abs().max()
                                                 + 1e-30)).max()) for k, w in want.items())

    for dtype in ("float32", "bfloat16"):
        (out0, g0, _), (out1, g1, calls), (_, g_moved, _), _ = res[0][dtype]
        assert calls == 40, dtype
        for k, w in out0.items():
            d, top = (out1[k] - w).abs().max(), w.abs().max()
            assert float(d) <= (1e-5 if dtype == "float32" else 2e-2) * float(top), (dtype, k)
        bar = 1.0 if dtype == "float32" else max(1.0, 2 * worst(g_moved, g0))
        assert worst(g1, g0) <= bar, (dtype, worst(g1, g0), bar)
        for k, v in res[0][dtype][3].items():
            assert torch.equal(v, res[1][dtype][3][k]), (dtype, k)


_NCCL_WORLD_ONE = r"""
import sys
import torch
import torch.distributed as dist
from cl_object_detection_tpu_torch.parallel import mesh as pm
store = sys.argv[1]
assert pm.backend_for(torch.device("cuda", 0), 1) == "nccl"
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + store, world_size=1, rank=0)
mesh = pm.DataMesh(rank=0, world=1, device=torch.device("cuda", 0), backend="nccl")
assert mesh.comm_device == torch.device("cuda", 0)
x = torch.arange(5, dtype=torch.float32, device="cuda")
dist.all_reduce(x)
box = [{"rank": 0}]
dist.broadcast_object_list(box, src=0, device=mesh.comm_device)
dist.barrier(device_ids=[0])
assert torch.equal(x.cpu(), torch.arange(5.0)) and box == [{"rank": 0}]
dist.destroy_process_group()
print("nccl ok")
"""


def test_nccl_world_one_group_on_the_card(dev, tmp_path):
    """A one-rank NCCL group on the card: the backend the rule picks for a
    rank with a card of its own; its all-reduce, object broadcast and
    barrier run."""
    out = _run_children(_NCCL_WORLD_ONE, [(str(tmp_path / "store"),)])
    assert "nccl ok" in out[0]


_BUILD_INTO = r"""
import sys
from pathlib import Path
from cl_object_detection_tpu_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build.build_all()
for name in _build.EXTRA_FLAGS:
    _build.load(name)
print("built", sorted(_build.build_seconds))
"""


def test_two_processes_build_the_kernels_at_once(dev, tmp_path):
    """Two ranks start on an empty build directory together: both build
    every kernel (per-process temporary files, renamed into place), both
    load them, and the directory ends with one library per source and no
    temporary file."""
    from cl_object_detection_tpu_torch import _build

    build = tmp_path / "kernels"
    _run_children(_BUILD_INTO, [(str(build),), (str(build),)], timeout=600)
    names = sorted(p.name for p in build.iterdir())
    assert len(names) == len(_build.EXTRA_FLAGS), names
    assert all(n.endswith(".so") for n in names), names
