"""The stem kernel's decomposition (csrc/stem_fused.cu), walked in plain
PyTorch on the CPU and held to the JAX package's ``stem_fused_reference``.

The kernel cannot run here, but its index arithmetic can: 8 x 16 windows
of conv pixels with the pool's halo above and to the left (7 x 15
pooled outputs each, ragged edges masked), per-tap patch rows gathered
at the 2-D pixel map with zero fill, the (256, 576) K-major weight, the
rounding sequence (conv value, + bias, both in the input's dtype, ReLU),
and -inf at conv row / col -1 before the phase-block max. ``_stem_by_units``
mirrors the kernel's producer (gather), consumer (per-tap products) and
epilogue (tile, pool) unit by unit; shapes are ragged against the unit.

This checks a model of the kernel, written by hand from its source, and
not the kernel itself: the only port code it runs is
``stem_weight_kmajor``. An index error in ``csrc/stem_fused.cu`` that the
model does not copy shows only in the card tests
(``tests/test_torch_cuda.py``), which run the kernel at ragged shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.ops import stem_pallas as jsp
from cl_object_detection_tpu_torch.ops import stem_fused as tsf

torch.set_num_threads(1)

WIN_R, WIN_C = 8, 16                       # conv pixels of a unit
OUT_R, OUT_C = WIN_R - 1, WIN_C - 1        # pooled outputs of a unit


def _stem_by_units(x4: torch.Tensor, k3: torch.Tensor, bias4: torch.Tensor) -> torch.Tensor:
    dtype = x4.dtype
    bsz, h4, w4, _ = x4.shape
    wt = tsf.stem_weight_kmajor(k3.to(dtype))              # (256, 576)
    bias = bias4.reshape(256).to(dtype).float()
    out = torch.empty_like(x4)
    r = torch.arange(WIN_R)[:, None]
    c = torch.arange(WIN_C)[None, :]
    for b in range(bsz):
        for i0 in range(0, h4, OUT_R):
            for j0 in range(0, w4, OUT_C):
                acc = torch.zeros(WIN_R * WIN_C, 256)
                for t in range(9):                            # one 128-byte slice per tap
                    tt, uu = divmod(t, 3)
                    gi = (i0 - 2 + r + tt).expand(WIN_R, WIN_C)
                    gj = (j0 - 2 + c + uu).expand(WIN_R, WIN_C)
                    ok = (gi >= 0) & (gi < h4) & (gj >= 0) & (gj < w4)
                    a = torch.zeros(WIN_R, WIN_C, 64, dtype=dtype)
                    a[ok] = x4[b, gi[ok], gj[ok]]             # zero fill: the conv's padding
                    acc += a.reshape(-1, 64).float() @ wt[:, t * 64:(t + 1) * 64].float().T
                y = acc.to(dtype).float()
                v = (y + bias).to(dtype).float().clamp_min(0).reshape(WIN_R, WIN_C, 256)
                v[((i0 - 1 + r) < 0) | ((j0 - 1 + c) < 0)] = float("-inf")
                up, cur = v[:OUT_R], v[1:]
                blk = lambda t, p: t[..., 64 * p:64 * (p + 1)]   # noqa: E731
                m = blk(up[:, :OUT_C], 3)
                for t, p in ((up[:, 1:], 2), (up[:, 1:], 3), (cur[:, :OUT_C], 1),
                             (cur[:, :OUT_C], 3), (cur[:, 1:], 0), (cur[:, 1:], 1),
                             (cur[:, 1:], 2), (cur[:, 1:], 3)):
                    m = torch.maximum(m, blk(t, p))
                nr, nc = min(OUT_R, h4 - i0), min(OUT_C, w4 - j0)
                out[b, i0:i0 + nr, j0:j0 + nc] = m[:nr, :nc].to(dtype)
    return out


def _inputs(b, h4, w4, seed):
    r = np.random.RandomState(seed)
    x4 = r.randn(b, h4, w4, 64).astype(np.float32)
    k3 = (r.randn(3, 3, 64, 256) * 0.05).astype(np.float32)
    bias4 = (r.randn(256) * 0.3).astype(np.float32)
    return x4, k3, bias4


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h4", [1, 7, 8, 15])
@pytest.mark.parametrize("w4", [1, 15, 16, 31])
def test_unit_walk_matches_jax_reference(b, h4, w4):
    """fp32, rtol = atol = 2e-4 (the walk sums per tap, the reference
    conv in its own order)."""
    x4, k3, bias4 = _inputs(b, h4, w4, seed=100 * b + 10 * h4 + w4)
    want = np.asarray(jsp.stem_fused_reference(jnp.asarray(x4), jnp.asarray(k3),
                                               jnp.asarray(bias4)))
    got = _stem_by_units(torch.from_numpy(x4), torch.from_numpy(k3), torch.from_numpy(bias4))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", [(2, 9, 17), (1, 15, 31)])
def test_unit_walk_in_bf16_matches_plain_version(shape):
    """bf16, the rounding sequence exercised: within 2 bf16 ulps of
    |plain| + max|bias| of the port's ``stem_fused_reference`` (the two
    sum the 576 products in f32 in different orders, which can move the
    conv value's bf16 rounding by one ulp before the bias add), the
    kernel's bar on the card."""
    x4, k3, bias4 = _inputs(*shape, seed=sum(shape))
    x = torch.from_numpy(x4).to(torch.bfloat16)
    k = torch.from_numpy(k3).to(torch.bfloat16)
    bias = torch.from_numpy(bias4)
    got = _stem_by_units(x, k, bias).float()
    want = tsf.stem_fused_reference(x, k, bias).float()
    mag = (want.abs() + bias.abs().max()).clamp_min(2.0 ** -126)
    tol = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got - want).abs() <= tol).all())


def test_kmajor_weight_is_the_packed_kernel_transposed():
    k3 = torch.from_numpy(_inputs(1, 1, 1, seed=3)[1])
    wt = tsf.stem_weight_kmajor(k3)
    assert wt.shape == (256, 576) and wt.is_contiguous()
    assert torch.equal(wt, k3.reshape(576, 256).T)
    # tap t = (T, U) is columns [t*64, t*64+64): one 128-byte bf16 slice
    for t in (0, 4, 8):
        assert torch.equal(wt[:, t * 64:(t + 1) * 64], k3[t // 3, t % 3].T)
