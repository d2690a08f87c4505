"""Fused stem port (cl_object_detection_tpu_torch.ops.stem_fused): the
packed kernel and the plain version against the JAX package's
``stem_pallas`` (reference and Pallas kernel in interpret mode), the
fused backbone against the RGB backbone, and uint8 normalization."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.ops import stem_pallas as jsp
from cl_object_detection_tpu.models.resnet import _device_normalize as j_norm
from cl_object_detection_tpu_torch.data.transforms import space_to_depth
from cl_object_detection_tpu_torch.models.resnet import (
    ResNetBackbone,
    _device_normalize as t_norm,
    _normalize_stats as t_stats,
)
from cl_object_detection_tpu_torch.ops import stem_fused as tsf

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _stem_inputs(seed, H=64, W=96):
    x = _rand((2, H, W, 3), seed, 0.5)
    k7 = _rand((7, 7, 3, 64), seed + 1, 0.2)
    bias = _rand((64,), seed + 2, 0.05)
    return space_to_depth(x, factor=4), k7, np.tile(bias, 4)


def test_pack_stem_kernel_bit_equal():
    k7 = _rand((7, 7, 3, 64), 1, 0.2)
    np.testing.assert_array_equal(
        tsf.pack_stem_kernel(torch.from_numpy(k7)).numpy(),
        np.asarray(jsp.pack_stem_kernel(jnp.asarray(k7))))


@pytest.mark.parametrize("hw", [(64, 96), (36, 44)])
def test_plain_stem_matches_jax_reference_and_pallas_interpret(hw):
    """rtol = atol = 1e-5 in f32, as the JAX package holds its own kernel
    to its reference (summation order differs)."""
    x4, k7, b4 = _stem_inputs(5, *hw)
    k3 = jsp.pack_stem_kernel(jnp.asarray(k7))
    want = np.asarray(jsp.stem_fused_reference(jnp.asarray(x4), k3, jnp.asarray(b4)))
    got = tsf.stem_fused(torch.from_numpy(x4), torch.from_numpy(np.array(k3)),
                         torch.from_numpy(b4)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if x4.shape[1] % 8 == 0:
        pallas = np.asarray(jsp._stem_fused_pallas(
            jnp.asarray(x4), k3.reshape(576, 256), jnp.asarray(b4).reshape(1, 256),
            interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version_without_counting():
    x4, k7, b4 = _stem_inputs(8, 32, 32)
    k3 = tsf.pack_stem_kernel(torch.from_numpy(k7))
    before = tsf.stem_fused.launches
    got = tsf.stem_fused(torch.from_numpy(x4), k3, torch.from_numpy(b4))
    ref = tsf.stem_fused_reference(torch.from_numpy(x4), k3, torch.from_numpy(b4))
    assert torch.equal(got, ref)
    assert tsf.stem_fused.launches == before


def test_f32_wrapper_on_cpu_matches_jax_reference_without_counting():
    """The float32 form's wrapper on a CPU tensor takes the 7x7 kernel and
    runs the plain version on its packed form, held to JAX's reference
    on JAX's packed kernel at rtol = atol = 1e-5, no launch counted."""
    x4, k7, b4 = _stem_inputs(9, 36, 44)
    k3 = jsp.pack_stem_kernel(jnp.asarray(k7))
    want = np.asarray(jsp.stem_fused_reference(jnp.asarray(x4), k3, jnp.asarray(b4)))
    before = tsf.stem_fused_f32.launches
    got = tsf.stem_fused_f32(torch.from_numpy(x4), torch.from_numpy(k7), torch.from_numpy(b4))
    assert tsf.stem_fused_f32.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_f32_wrapper_refuses_other_dtypes():
    """Another dtype raises TypeError; a packed (3,3,64,256) kernel in
    place of the 7x7 one raises ValueError."""
    x4, k7, b4 = _stem_inputs(10, 32, 32)
    k3 = tsf.pack_stem_kernel(torch.from_numpy(k7))
    with pytest.raises(TypeError):
        tsf.stem_fused_f32(torch.from_numpy(x4).to(torch.bfloat16), torch.from_numpy(k7),
                           torch.from_numpy(b4))
    with pytest.raises(ValueError):
        tsf.stem_fused_f32(torch.from_numpy(x4), k3, torch.from_numpy(b4))


def _support_mask():
    """Entries of a (3,3,64,256) packed kernel that some 7x7 tap lands
    on, from JAX's packing of a kernel of ones."""
    return np.asarray(jsp.pack_stem_kernel(jnp.ones((7, 7, 3, 64), jnp.float32))) != 0


def test_packed_kernel_support_is_147_of_576_rows():
    """Each of the 256 packed columns takes 147 of its 576 K-rows from the
    7x7 kernel (49 taps x 3 channels); the other 429, the 16 pad channels
    of each tap and the taps outside the support, are zero. This is the
    work the float32 form skips."""
    mask = _support_mask().reshape(576, 256)
    assert (mask.sum(0) == 147).all()
    assert not mask.reshape(3, 3, 64, 256)[:, :, 48:].any()


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_compact_f32_weight_from_jax_packed_kernel(seed):
    """The compact float32 weight gathered from JAX's ``pack_stem_kernel``
    of k7 holds k7's 147 x 64 entries in the kernel's (kh, c, kw) order,
    every entry of k3 it drops is zero, and packing it again gives k3
    back (the device check of ``stem_fused`` on a float32 CUDA tensor)."""
    k7 = _rand((7, 7, 3, 64), seed, 0.2)
    k3 = np.array(jsp.pack_stem_kernel(jnp.asarray(k7)))
    t3 = torch.from_numpy(k3)
    got7 = tsf.unpack_stem_kernel(t3)
    np.testing.assert_array_equal(got7.numpy(), k7)
    w = tsf.stem_weight_f32(got7).numpy()
    assert w.shape == (147, 64)
    for kh in range(7):
        for kw in range(7):
            for c in range(3):
                np.testing.assert_array_equal(w[(kh * 3 + c) * 7 + kw], k7[kh, kw, c])
    assert (k3[~_support_mask()] == 0).all()
    assert torch.equal(tsf.pack_stem_kernel(got7), t3)


def test_off_support_k3_fails_the_pack_check():
    """A k3 with one non-zero entry outside the 7x7 support does not pack
    back from its 7x7 kernel: the check ``stem_fused`` runs on the card
    (there as ``torch._assert_async``) is false for it."""
    k7 = _rand((7, 7, 3, 64), 24, 0.2)
    k3 = tsf.pack_stem_kernel(torch.from_numpy(k7))
    for idx in np.argwhere(~_support_mask())[[0, 1000, -1]]:
        bad = k3.clone()
        bad[tuple(idx)] = 0.5
        assert not bool(torch.eq(tsf.pack_stem_kernel(tsf.unpack_stem_kernel(bad)), bad).all())
    assert bool(torch.eq(tsf.pack_stem_kernel(tsf.unpack_stem_kernel(k3)), k3).all())


def _randomize_bn(bb, seed):
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for m in bb.modules():
            if hasattr(m, "running_var"):
                c = m.running_var.numel()
                m.running_mean.copy_(torch.from_numpy(r.randn(c).astype(np.float32) * 0.1))
                m.running_var.copy_(torch.from_numpy(np.abs(r.randn(c)).astype(np.float32) * 0.1 + 1.0))
                m.weight.copy_(torch.from_numpy(1 + r.randn(c).astype(np.float32) * 0.1))
                m.bias.copy_(torch.from_numpy(r.randn(c).astype(np.float32) * 0.05))


def test_backbone_fused_and_s2d_match_rgb():
    """The port's backbone on 64- and 12-channel space-to-depth batches
    equals its RGB path (f32, rtol = atol = 2e-4), BN fold included."""
    bb = ResNetBackbone(depth=18, generator=torch.Generator().manual_seed(0)).eval()
    _randomize_bn(bb, 9)
    x = _rand((2, 64, 96, 3), 12, 0.5)
    with torch.no_grad():
        ref = bb(torch.from_numpy(x))
        for factor in (4, 2):
            out = bb(torch.from_numpy(space_to_depth(x, factor=factor)))
            for a, b in zip(ref, out):
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("c", [3, 12, 64])
def test_uint8_device_normalize_bit_equal(c):
    img = np.random.RandomState(15).randint(0, 256, (1, 16, 16, 3)).astype(np.uint8)
    x = img if c == 3 else space_to_depth(img, factor=2 if c == 12 else 4)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_array_equal(
        t_norm(torch.from_numpy(x), *t_stats(mean, std, c), torch.float32).numpy(),
        np.asarray(j_norm(jnp.asarray(x), mean, std, jnp.float32)))
