"""The IL tool passes on the port's data axis (JAX's
tests/test_tool_sharding.py mirrored), on the CPU: the similarity, the MAS
importance, herding, the prototypes with both prototype-herd modes and
the pseudo-labels, each with ``mesh=`` on two gloo ranks
(``tests/torch_mesh_worker.py``), equal one process's. Each pass runs
whole on every rank and every rank keeps rank 0's result, so both ranks
hold the single-process values bit for bit.

An old model of scenario 3+2 (R18, FPN 32, 2 head layers, float32, its
output convs random and its classification bias raised so that old-class
scores pass the similarity gate and the pseudo-label threshold) over 16
toy images at 128 x 192 frames; herding keeps every (image, class) pair
whose boxes cover 5% of the image (the toy boxes are small).
"""
import os
import sys

import numpy as np
import pytest
import torch

from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import case_tools, run_ranks  # noqa: E402

torch.set_num_threads(2)

MODEL = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
BIAS_RAISE = 3.0


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy_mesh_tools"))
    json_path = make_toy_dataset(root, num_images=16, seed=5, image_size=(48, 64))
    model = create_retinanet(tcfg.ModelConfig(**MODEL), 3, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model.classification_head.output.bias += BIAS_RAISE
        for head in (model.classification_head, model.regression_head):
            head.output.weight.copy_(torch.randn(head.output.weight.shape, generator=gen) * 0.01)
    args = dict(json=json_path, images=os.path.join(root, "images"),
                model_cfg=tcfg.ModelConfig(**MODEL), state_dict=model.state_dict(),
                data_cfg=tcfg.DataConfig(batch_size=4, min_side=100, max_side=192, height=128,
                                         width=192, max_boxes=8, num_workers=0, prefetch=0),
                herd_ratio=0.05, pseudo_cfg=tcfg.PseudoLabelConfig(enabled=True,
                                                                   score_thresh=0.2))
    ranks = run_ranks(str(tmp_path_factory.mktemp("mesh_tools")), "tools", args)
    return ranks, case_tools(None, args, root)


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return a == b


def test_tool_passes_on_two_ranks_equal_one_process(tools):
    """Every pass's result on both ranks equals one process's, and the
    passes give something to compare: a nonzero similarity and
    importance, exemplar picks, and pseudo-labels. (One test: the passes
    share one spawn, which a test per pass would repeat on every test
    worker that runs one.)"""
    ranks, one = tools
    for key in ("similarity", "importance", "herd", "herd_list", "prototypes",
                "proto_slots", "proto_mean", "pseudo"):
        assert _equal(ranks[0][key], ranks[1][key]), key
        assert _equal(ranks[0][key], one[key]), key
    assert one["similarity"].sum() > 0
    assert any(v.any() for v in one["importance"].values())
    assert one["herd_list"] and any(one["pseudo"].values())
    assert any(one["proto_mean"].values())
