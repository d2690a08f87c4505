"""RetinaNet port (cl_object_detection_tpu_torch.models) against the JAX
package's flax model, from one set of weights carried across by
``models.bridge.load_jax_variables``: flax init of an R18 with
non-trivial BN statistics and random output convs; cls, reg and P3-P7 at
rtol = atol = 2e-4 in f32 for RGB, fused-stem float and fused-stem uint8
input. Plus the bridge's strict coverage and the npz round trip."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_object_detection_tpu.config import ModelConfig as JModelConfig
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu_torch.config import ModelConfig
from cl_object_detection_tpu_torch.data.transforms import space_to_depth
from cl_object_detection_tpu_torch.models.bridge import (
    load_jax_variables,
    load_npz,
    save_npz,
)
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

torch.set_num_threads(1)

CFG = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
NUM_CLASSES = 3
H, W = 64, 96


def jax_variables(seed=0):
    """flax init of the small R18, with random BN statistics and affines
    and random (non-zero) head output convs, as numpy."""
    model = j_create(JModelConfig(**CFG), NUM_CLASSES)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))
    v = jax.tree.map(np.array, v)
    r = np.random.RandomState(seed + 100)

    def walk(node, path=()):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            if path[-1:] == ("bn",):
                if key == "mean":
                    node[key] = (r.randn(*val.shape) * 0.1).astype(np.float32)
                elif key == "var":
                    node[key] = (np.abs(r.randn(*val.shape)) * 0.2 + 0.8).astype(np.float32)
                elif key == "scale":
                    node[key] = (1 + r.randn(*val.shape) * 0.1).astype(np.float32)
                else:
                    node[key] = (r.randn(*val.shape) * 0.05).astype(np.float32)
            elif "output" in path:
                node[key] = (r.randn(*val.shape) * 0.05).astype(np.float32)

    walk(v)
    return model, v


def port_model(variables):
    model = create_retinanet(ModelConfig(**CFG), NUM_CLASSES, device="cpu")
    load_jax_variables(model, variables)
    return model


@pytest.fixture(scope="module")
def pair():
    jmodel, v = jax_variables()
    return jmodel, v, port_model(v)


def _compare(jmodel, v, tmodel, x_np):
    jcls, jreg, jfeats = jmodel.apply(v, jnp.asarray(x_np), method=jmodel.forward_all)
    with torch.no_grad():
        tcls, treg, tfeats = tmodel.forward_all(torch.from_numpy(x_np))
    np.testing.assert_allclose(tcls.numpy(), np.asarray(jcls), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(treg.numpy(), np.asarray(jreg), rtol=2e-4, atol=2e-4)
    for tf, jf in zip(tfeats, jfeats):
        np.testing.assert_allclose(tf.permute(0, 2, 3, 1).numpy(), np.asarray(jf),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("form", ["rgb", "fused_float", "fused_uint8"])
def test_forward_matches_jax(pair, form):
    jmodel, v, tmodel = pair
    r = np.random.RandomState(21)
    if form == "rgb":
        x = (r.randn(2, H, W, 3) * 0.5).astype(np.float32)
    elif form == "fused_float":
        x = space_to_depth((r.randn(2, H, W, 3) * 0.5).astype(np.float32), factor=4)
    else:
        x = space_to_depth(r.randint(0, 256, (2, H, W, 3)).astype(np.uint8), factor=4)
    _compare(jmodel, v, tmodel, x)


def test_frozen_bn_refuses_grad_mode(pair):
    """The serving slice ports inference only: a forward with autograd
    on raises instead of running an untested path."""
    _, _, tmodel = pair
    x = torch.zeros(1, H, W, 3)
    with pytest.raises(RuntimeError, match="inference only"):
        tmodel(x)


def test_bridge_covers_every_leaf_once(pair):
    _, v, tmodel = pair
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert n_leaves == len(tmodel.state_dict())


def test_bridge_raises_on_missing_leaf():
    _, v = jax_variables()
    v = copy.deepcopy(v)
    del v["params"]["fpn"]["p6"]["bias"]
    with pytest.raises(ValueError, match="fpn.p6.bias"):
        port_model(v)


def test_bridge_raises_on_extra_leaf():
    _, v = jax_variables()
    v = copy.deepcopy(v)
    v["params"]["fpn"]["p8"] = {"kernel": np.zeros((3, 3, 32, 32), np.float32)}
    with pytest.raises(ValueError, match="fpn.p8.weight"):
        port_model(v)


def test_npz_round_trip(tmp_path):
    _, v = jax_variables()
    path = str(tmp_path / "w.npz")
    save_npz(path, v)
    back = load_npz(path)
    want = {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(v)[0]}
    got = {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
