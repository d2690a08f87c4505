"""Conv mode of the port's int8 kernel (``ops/int8_matmul.py``) on the
CPU: its plain version against JAX's int8 convolution, the wrappers'
CPU behaviour, how ``ops/quant.py`` routes each conv, the kernel's tile
plans, and the kernel build's hash over the headers a source includes.

* ``int8_conv_nhwc_reference`` (im2col, then the plain GEMM) bit-identical
  to ``jax.lax.conv_general_dilated`` on the same int8 inputs (s8 x s8 ->
  s32, the computation of the JAX package's ``ops/quant.py``), then the
  same float32 dequantize;
* on CPU tensors the wrappers run their plain versions and count no
  launch;
* ``quantized_conv`` sends a 3x3 conv with C % 16 == 0 to conv mode, a
  1x1 conv to GEMM mode without im2col, anything else to im2col + GEMM.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch import _build
from cl_object_detection_tpu_torch.ops import int8_matmul as im
from cl_object_detection_tpu_torch.ops import quant as tq

from test_torch_cuda import CONV_SHAPES, GEMM_K, GEMM_M, GEMM_N

torch.set_num_threads(1)


def _int8_conv_inputs(k, c, n, seed, bias, hw=(9, 11), batch=2):
    r = np.random.RandomState(seed)
    x = r.randint(-127, 128, (batch, *hw, c)).astype(np.int8)
    w_hwio = r.randint(-127, 128, (k, k, c, n)).astype(np.int8)
    scale = (r.rand(n) * 1e-3).astype(np.float32)
    b = r.randn(n).astype(np.float32) if bias else None
    return x, w_hwio, scale, b


def _jax_int8_conv(x, w_hwio, scale, b, stride, padding, out_dtype):
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w_hwio), window_strides=(stride, stride),
        padding=[(padding, padding), (padding, padding)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(scale)
    if b is not None:
        y = y + jnp.asarray(b)
    return np.asarray(y.astype(out_dtype).astype(jnp.float32))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_conv_reference_bit_identical_to_jax_conv(k, stride, padding, c, bias, out_dtype):
    """Odd 9x11 images; the int32 sums are exact on both sides and the
    dequantize rounds the same float32 steps, then the same cast."""
    x, w_hwio, scale, b = _int8_conv_inputs(k, c, 24, seed=k + 3 * stride + 7 * padding + c,
                                            bias=bias)
    want = _jax_int8_conv(x, w_hwio, scale, b, stride, padding, getattr(jnp, out_dtype))
    w_nk = torch.from_numpy(w_hwio.transpose(3, 0, 1, 2).reshape(24, k * k * c).copy())
    got = im.int8_conv_nhwc_reference(
        torch.from_numpy(x), w_nk, torch.from_numpy(scale),
        None if b is None else torch.from_numpy(b), kernel=k, stride=stride, padding=padding,
        out_dtype=getattr(torch, out_dtype))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_wrappers_on_cpu_run_the_plain_versions_without_counting():
    x, w_hwio, scale, b = _int8_conv_inputs(3, 24, 8, seed=5, bias=True)   # C % 16 != 0
    xt, st, bt = torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(b)
    w_nk = torch.from_numpy(w_hwio.transpose(3, 0, 1, 2).reshape(8, -1).copy())
    kw = dict(kernel=3, stride=2, padding=1)
    before = (im.int8_matmul.launches, im.int8_conv_nhwc.launches)
    got = im.int8_conv_nhwc(xt, w_nk, st, bt, **kw)
    assert torch.equal(got, im.int8_conv_nhwc_reference(xt, w_nk, st, bt, **kw))
    assert got.shape == (2, 5, 6, 8) and got.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="int8"):
        im.int8_conv_nhwc(xt.float(), w_nk, st, **kw)
    with pytest.raises(ValueError, match="weight"):
        im.int8_conv_nhwc(xt, w_nk[:, :-1], st, **kw)
    with pytest.raises(ValueError, match="scale"):
        im.int8_conv_nhwc(xt, w_nk, st[:4], **kw)
    with pytest.raises(ValueError, match="does not fit"):
        im.int8_conv_nhwc(xt[:, :2, :2], w_nk, st, kernel=3, stride=1, padding=0)
    assert (im.int8_matmul.launches, im.int8_conv_nhwc.launches) == before


# (kernel, C, stride, padding) -> the route quantized_conv takes
ROUTES = [
    ((3, 16, 1, 1), "conv"),
    ((3, 32, 2, 1), "conv"),
    ((3, 8, 1, 1), "im2col"),
    ((3, 24, 2, 1), "im2col"),
    ((1, 16, 1, 0), "gemm"),
    ((1, 8, 2, 0), "gemm"),
    ((5, 16, 1, 2), "im2col"),
]


@pytest.mark.parametrize("shape,route", ROUTES)
def test_quantized_conv_routes_by_shape(monkeypatch, shape, route):
    """A spy on each wrapper (``_run_quantized`` and ``quantized_conv``
    look them up per call): the conv lands in exactly one route, and the
    result is the one the plain route gives."""
    k, c, stride, padding = shape
    r = np.random.RandomState(k * 100 + c)
    x = torch.from_numpy(r.randn(2, 11, 9, c).astype(np.float32)).permute(0, 3, 1, 2)
    w = torch.from_numpy((r.randn(12, c, k, k) * 0.1).astype(np.float32))
    b = torch.from_numpy(r.randn(12).astype(np.float32))
    kw = dict(stride=stride, padding=padding)
    want = tq.quantized_conv(x, w, b, **kw)
    calls = []
    for name in ("int8_conv_nhwc", "int8_matmul", "im2col"):
        real = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _n=name, _f=real, **kv: calls.append(_n)
                            or _f(*a, **kv))
    got = tq.quantized_conv(x, w, b, **kw)
    assert {"conv": ["int8_conv_nhwc"], "gemm": ["int8_matmul"],
            "im2col": ["im2col", "int8_matmul"]}[route] == calls
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n,conv,plan", [
    (62976, 2304, 256, False, (128, 1)),     # the TPU tool's shape
    (1011712, 64, 256, False, (128, 1)),     # layer1 1x1 expand
    (1011712, 256, 64, False, (64, 1)),      # layer1 1x1 reduce
    (4160, 18432, 256, False, (128, 2)),     # fpn.p6 on im2col patches
    (1120, 2304, 256, False, (64, 1)),       # head P7 on im2col patches
    (1011712, 576, 64, True, (64, 1)),       # layer1 3x3
    (252928, 1152, 128, True, (128, 1)),     # layer2 3x3 stride 2
    (252928, 2304, 256, True, (256, 1)),     # head trunk P3
    (15808, 2304, 256, True, (256, 1)),      # head trunk P5: 124 tiles
    (4160, 2304, 256, True, (64, 1)),        # head trunk P6: narrowed
    (4160, 18432, 256, True, (128, 2)),      # fpn.p6: long K, split
    (17, 18432, 64, False, (64, 4)),
])
def test_tile_plan_by_shape(m, k, n, conv, plan):
    assert im.tile_plan(m, n, k, conv, sms=132) == plan


def test_card_tests_run_every_tile_plan():
    """The card's GEMM grid and conv shapes (tests/test_torch_cuda.py)
    reach each width with one K slice run and, where the plan splits K
    at all, split."""
    plans = {im.tile_plan(m, n, k, False, 132) for m in GEMM_M for k in GEMM_K for n in GEMM_N}
    for b, h, w, c, n, ks, s, p in CONV_SHAPES:
        m = b * ((h + 2 * p - ks) // s + 1) * ((w + 2 * p - ks) // s + 1)
        plans.add(im.tile_plan(m, n, ks * ks * c, True, 132))
    assert {(64, 1), (128, 1), (256, 1)} <= plans
    assert {bn for bn, splits in plans if splits > 1} == {64, 128}


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes, directly or through
    another header, renames (so rebuilds) the library; other files do
    not."""
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\n#include <cuda.h>\nint f();\n')
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int A = 1;\n")
    (tmp_path / "other.cuh").write_text("constexpr int B = 1;\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setitem(_build.EXTRA_FLAGS, "k", [])
    assert [p.name for p in _build._sources("k")] == ["k.cu", "outer.cuh", "inner.cuh"]
    first = _build._lib_path("k")
    (tmp_path / "other.cuh").write_text("constexpr int B = 2;\n")
    assert _build._lib_path("k") == first
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int A = 2;\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n// edited\n')
    assert _build._lib_path("k") not in (first, second)


def test_kernel_sources_hash_their_header():
    assert [p.name for p in _build._sources("int8_matmul")] == ["int8_matmul.cu", "hopper.cuh"]
