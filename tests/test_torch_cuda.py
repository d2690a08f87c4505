"""The port's CUDA kernels against their plain versions on the card, at
shapes the main path does not give them: ragged stem tiles, a batch of
one, k that is not a multiple of 32, int8 GEMMs with ragged M, N and K
(every tile width and K split the kernel chooses), int8 convs with
ragged images, strides and paddings, NMS from k = 1 to 4096 with empty
and degenerate images, the stem's float32 form and its refusal of a
kernel that is not packed, and the wrappers' refusals. Then the train
path: the stem Function's backward on the card, gradients reaching the
stem's parameters through the kernel, and one float32 apply on the card
against the same apply on the CPU.

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
               (5, 22, 29), (32, 152, 208)]


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
