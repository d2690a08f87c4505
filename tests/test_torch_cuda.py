"""The port's CUDA kernels against their plain versions on the card, at
shapes the main path does not give them: ragged stem tiles, a batch of
one, k that is not a multiple of 32, and the wrappers' refusals.

Marked ``cuda``. Without a CUDA device every test skips: a kernel has no
CPU mode, and the CPU tests hold the plain versions to the JAX package.
On a machine with a card (the tests directory's conftest imports JAX,
which that machine need not have, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch.ops import nms as tn
from cl_object_detection_tpu_torch.ops import nms_fp as nf
from cl_object_detection_tpu_torch.ops import stem_fused as sf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _stem_inputs(dev, b, h4, w4, seed):
    r = np.random.RandomState(seed)
    x4 = np.zeros((b, h4, w4, 64), np.float32)
    x4[..., :48] = r.randn(b, h4, w4, 48)
    k7 = (r.randn(7, 7, 3, 64) * 0.05).astype(np.float32)
    bias4 = np.tile((r.randn(64) * 0.1).astype(np.float32), 4)
    x = torch.from_numpy(x4).to(dev, torch.bfloat16)
    k3 = sf.pack_stem_kernel(torch.from_numpy(k7).to(dev)).to(torch.bfloat16)
    return x, k3, torch.from_numpy(bias4).to(dev)


def _bf16_ulp(x):
    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 37, 53), (2, 15, 15),
                                   (3, 16, 31), (2, 152, 208)])
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


def test_stem_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, k3, b4 = _stem_inputs(dev, 1, 8, 8, seed=6)
    before = sf.stem_fused.launches
    with pytest.raises(TypeError):
        sf.stem_fused(x.float(), k3, b4)
    with pytest.raises(ValueError):
        sf.stem_fused(x[..., :48], k3, b4)
    assert sf.stem_fused.launches == before


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


@pytest.mark.parametrize("b,k", [(1, 200), (5, 256), (2, 1000), (3, 1024)])
@pytest.mark.parametrize("near_threshold", [False, True])
def test_nms_kernel_bit_identical_to_plain(dev, b, k, near_threshold):
    bb, ss = _nms_inputs(b, k, seed=b * k, near_threshold=near_threshold)
    boxes, scores = torch.from_numpy(bb).to(dev), torch.from_numpy(ss).to(dev)
    before = nf.nms_fp.launches
    got = nf.nms_fp(boxes, scores, 0.5)
    torch.cuda.synchronize()
    assert nf.nms_fp.launches == before + 1
    want_dev = nf.nms_fp_reference(boxes, scores, 0.5)
    want_cpu = tn.nms_padded(torch.from_numpy(bb), torch.from_numpy(ss), 0.5)
    assert torch.equal(got, want_dev)
    assert torch.equal(got.cpu(), want_cpu)


def test_nms_kernel_refuses_k_beyond_shared_memory(dev):
    k = nf.max_k() + 32
    before = nf.nms_fp.launches
    with pytest.raises(ValueError, match="shared-memory"):
        nf.nms_fp(torch.zeros(1, k, 4, device=dev), torch.zeros(1, k, device=dev))
    assert nf.nms_fp.launches == before


@pytest.mark.parametrize("topk", [512, 1000, 200])
def test_detect_batch_pallas_fp_equals_iterative_on_the_card(dev, topk):
    """pallas_fp launches the kernel at every k it can hold, not only at
    multiples of 256."""
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
