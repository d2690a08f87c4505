"""Port vs JAX package: anchors, transforms, box math and the phase pool
(cl_object_detection_tpu_torch.ops / .data against their JAX
counterparts, on the CPU, from seeded numpy inputs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.data import transforms as jt
from cl_object_detection_tpu.ops import anchors as ja
from cl_object_detection_tpu.ops import boxes as jb
from cl_object_detection_tpu.ops.pool import phase_pool as j_phase_pool
from cl_object_detection_tpu_torch.data import transforms as tt
from cl_object_detection_tpu_torch.ops import anchors as ta
from cl_object_detection_tpu_torch.ops import boxes as tb
from cl_object_detection_tpu_torch.ops.pool import phase_pool as t_phase_pool

torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(608, 832), (64, 96), (100, 70), (640, 1024)])
def test_anchors_bit_equal(hw):
    got = ta.anchors_for_shape(*hw)
    want = ja.anchors_for_shape(*hw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert ta.num_anchors_for_shape(*hw) == ja.num_anchors_for_shape(*hw) == len(got)


def test_anchor_count_of_the_serving_frame():
    assert len(ta.anchors_for_shape(608, 832)) == 94851


@pytest.mark.parametrize("factor,c", [(2, 3), (4, 3)])
def test_space_to_depth_bit_equal(factor, c):
    x = np.random.RandomState(1).rand(2, 16, 24, c).astype(np.float32)
    got = tt.space_to_depth(x, factor)
    np.testing.assert_array_equal(got, jt.space_to_depth(x, factor))
    assert tt.logical_image_hw(got) == jt.logical_image_hw(got) == (16, 24)
    u8 = (x * 255).astype(np.uint8)
    np.testing.assert_array_equal(tt.space_to_depth(u8, factor),
                                  jt.space_to_depth(u8, factor))


def test_normalize_image_bit_equal():
    x = np.random.RandomState(2).rand(8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(tt.normalize_image(x), jt.normalize_image(x))


def _boxes(r, n):
    xy = r.rand(n, 2).astype(np.float32) * 300
    wh = r.rand(n, 2).astype(np.float32) * 100 + 1
    return np.concatenate([xy, xy + wh], 1)


def test_decode_clip_iou_match_jax():
    r = np.random.RandomState(3)
    anchors = _boxes(r, 257)
    deltas = (r.randn(2, 257, 4) * 0.5).astype(np.float32)
    want = jb.clip_boxes(jb.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas)), 200, 300)
    got = tb.clip_boxes(tb.decode_boxes(torch.from_numpy(anchors), torch.from_numpy(deltas)), 200, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    a, b = _boxes(r, 40), _boxes(r, 30)
    np.testing.assert_allclose(
        tb.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jb.pairwise_iou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6, atol=0)


def test_phase_pool_exact():
    y4 = np.random.RandomState(4).randn(2, 5, 7, 256).astype(np.float32)
    np.testing.assert_array_equal(t_phase_pool(torch.from_numpy(y4)).numpy(),
                                  np.asarray(j_phase_pool(jnp.asarray(y4))))
