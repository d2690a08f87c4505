"""The plain reference held against the port's plain (CPU, float32) path
on seeded weights at a small frame. These tests import the port; the
reference itself does not."""
import numpy as np
import pytest
import torch

from port_bench import inputs, weights
from port_bench.common import build_model
from port_bench.reference import detect as rd
from port_bench.reference import train as rt
from port_bench.reference.retinanet import Net, param_specs, quant_conv

H, W = 64, 96
CFG = {"depth": 50, "fpn_channels": 256, "head_layers": 4, "num_anchors": 9, "prior": 0.01,
       "compute_dtype": "float32", "input_mean": [0.485, 0.456, 0.406],
       "input_std": [0.229, 0.224, 0.225]}


def _setup(depth=50, classes=20, seed=7):
    cfg = dict(CFG, depth=depth)
    p = weights.make(cfg, classes, seed, "cpu")
    rgb = inputs.frames(seed, 2, (H, W), (H, W - 6), "cpu")
    weights.calibrate(p, cfg, classes, rgb)
    return cfg, p, rgb


@pytest.mark.parametrize("depth", [50, 101])
def test_param_specs_are_the_ports_state_dict(depth):
    cfg, p, _ = _setup(depth)
    model = build_model(cfg, 20, p, "cpu")
    sd = model.state_dict()
    specs = param_specs(depth, 20)
    assert list(specs) == list(sd)
    assert all(tuple(sd[k].shape) == specs[k][0] for k in specs)


@pytest.mark.parametrize("depth", [50, 101])
def test_forward_matches_the_port_in_float32(depth):
    cfg, p, rgb = _setup(depth)
    model = build_model(cfg, 20, p, "cpu")
    with torch.no_grad():
        cls, reg, feats = Net(p, depth, 20).forward_all(rgb)
        c2, r2, f2 = model.forward_all(inputs.pack(rgb), enable_act=False)
    assert float(cls.std()) > 1.0
    torch.testing.assert_close(c2, cls, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(r2, reg, rtol=1e-4, atol=1e-4)
    for a, b in zip(f2, feats):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_outputs_depend_on_the_frame():
    """The seeded weights keep the frame's influence through the depth."""
    _, p, rgb = _setup()
    with torch.no_grad():
        cls, _, _ = Net(p, 50, 20).forward_all(rgb)
    assert float((cls[0] - cls[1]).abs().mean()) > 0.3 * float(cls.std())


def test_anchors_match_the_port():
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape

    for h, w in ((64, 96), (608, 832)):
        assert np.array_equal(rd.anchors(h, w), anchors_for_shape(h, w))


def test_detect_matches_the_port_on_the_same_logits():
    from cl_object_detection_tpu_torch.ops.nms import detect_batch

    _, p, rgb = _setup()
    with torch.no_grad():
        cls, reg, _ = Net(p, 50, 20).forward_all(rgb)
    anc = torch.from_numpy(rd.anchors(H, W))
    ref = rd.detect(cls, reg, anc, H, W, topk=256, max_det=100)
    det = detect_batch(cls, reg, anc, height=H, width=W, pre_nms_topk=256, max_detections=100,
                       scores_are_logits=True, nms_impl="pallas_fp")
    assert int(ref["valid"].sum()) > 100
    for k in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(getattr(det, k).to(ref[k].dtype), ref[k]), k


@pytest.mark.parametrize("shape", [(64, 64, 3, 1, 1), (64, 256, 1, 1, 0), (256, 512, 1, 2, 0),
                                   (128, 128, 3, 2, 1), (2048, 256, 3, 2, 1)])
def test_quant_conv_is_the_ports_int8_conv(shape):
    from cl_object_detection_tpu_torch.ops.quant import quantized_conv

    ci, co, k, s, pad = shape
    g = torch.Generator().manual_seed(ci + co + k)
    x = torch.relu(torch.randn(2, ci, 12, 20, generator=g))
    w = torch.randn(co, ci, k, k, generator=g) * 0.05
    b = torch.randn(co, generator=g)
    assert torch.equal(quantized_conv(x, w, b, stride=s, padding=pad),
                       quant_conv(x, w, b, s, pad, 127))


def test_state1_loss_and_steps_match_the_port_in_float32():
    """Two micro-steps and one apply of the port's train step (float32,
    distillation from a frozen teacher) against the reference's."""
    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig, DistillConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.config import ScheduleConfig
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step
    from port_bench.kinds.train_state1 import TERMS, student_weights

    cfg, teacher, rgb = _setup(classes=15)
    student = student_weights(teacher, cfg, 15, 20, 7, 0.05)
    boxes, labels = inputs.truth(7, 4, 32, 8, (16, 48), (H, W - 6), range(15, 20))
    model = build_model(cfg, 20, student, "cpu").train()
    tmodel = build_model(cfg, 15, teacher, "cpu")
    il = ILConfig(scenario=("15", "5"), start_state=1, distill=DistillConfig(enabled=True))
    statics = LossStatics(num_classes=20, num_past_class=15, incremental=True, use_distill=True)
    anc = rd.anchors(H, W)
    step = make_train_step(model, tmodel, anc, il, FocalConfig(), statics,
                           StepStatics(every_iter=2, grad_clip=0.1, num_past_class=15,
                                       num_knowing_class=20))
    state = TrainState(model, make_optimizer(ScheduleConfig(lr=1e-4), model))
    frames = inputs.frames(8, 4, (H, W), (H, W - 6), "cpu")
    losses, terms = [], []
    for i in range(2):
        sl = slice(2 * i, 2 * i + 2)
        state, m = step(state, inputs.pack(frames[sl]), torch.from_numpy(boxes[sl]),
                        torch.from_numpy(labels[sl]))
        losses.append(float(m["total_loss"]))
        terms.append({TERMS[k]: float(v) for k, v in m.items() if k in TERMS})
    batches = [(frames[2 * i:2 * i + 2], torch.from_numpy(boxes[2 * i:2 * i + 2]),
                torch.from_numpy(labels[2 * i:2 * i + 2]).long()) for i in range(2)]
    ref = rt.train(student, teacher, batches, torch.from_numpy(anc), depth=50, num_classes=20,
                   num_past=15, micro_steps=2, every_iter=2, lr=1e-4, clip=0.1)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    assert set(TERMS.values()) == set(ref["terms"][0]) and len(terms) == len(ref["terms"])
    for got, want in zip(terms, ref["terms"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # float32 round-off grows through the backward of a random deep net:
    # ~1e-5 of a leaf's norm at the heads, ~1e-3 in the backbone's first
    # stages; a wrong term or a missed leaf is off by far more
    one_minus_b1 = float(np.float32(1) - np.float32(0.9))
    for name, p in model.named_parameters():
        g = state.optimizer.state[p]["mu"] / one_minus_b1
        r = ref["grad1"][name]
        assert float((g - r).norm() / r.norm()) < 5e-3, name
        # Adam's first step moves each entry by about lr * sign(g): where
        # round-off flips the sign of a gradient near 0 the two differ by 2 lr
        moved = (p.detach() - ref["params"][name]).abs() > 1e-6
        assert float(moved.float().mean()) < 0.05, name
