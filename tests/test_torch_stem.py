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
