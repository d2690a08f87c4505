"""The port's ``models/convert.py`` against the JAX package's, on torch
state dicts built here (torchvision ResNet names, and the reference
RetinaNet's names): each loader gives the same model as JAX's function
followed by ``models.bridge.load_jax_variables`` (tensors equal); the
reference optimizer import gives the same Adam state as JAX's followed by
``models.bridge.load_optax_state``; the pickle gate refuses."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cl_object_detection_tpu.config import ModelConfig as JModelConfig
from cl_object_detection_tpu.config import ScheduleConfig as JScheduleConfig
from cl_object_detection_tpu.models import create_retinanet as j_create
from cl_object_detection_tpu.models import convert as jconvert
from cl_object_detection_tpu.train.optim import make_optimizer as j_make_optimizer
from cl_object_detection_tpu_torch.config import ModelConfig, ScheduleConfig
from cl_object_detection_tpu_torch.models import convert as tconvert
from cl_object_detection_tpu_torch.models.bridge import load_jax_variables, load_optax_state
from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
from cl_object_detection_tpu_torch.train.optim import make_optimizer

CFG = dict(depth=18, fpn_channels=32, head_layers=2, compute_dtype="float32")
C = 3
_FPN = {"p5_lateral": "P5_1", "p5_smooth": "P5_2", "p4_lateral": "P4_1", "p4_smooth": "P4_2",
        "p3_lateral": "P3_1", "p3_smooth": "P3_2", "p6": "P6", "p7": "P7_2"}
_HEADS = {"regression_head": "regressionModel", "classification_head": "classificationModel"}


def reference_key(port: str) -> str:
    """The torchvision / reference RetinaNet name of a port tensor."""
    mod, rest = port.split(".", 1)
    if mod == "fpn":
        sub, leaf = rest.split(".")
        return f"fpn.{_FPN[sub]}.{leaf}"
    if mod in _HEADS:
        return f"{_HEADS[mod]}.{rest}"
    m = re.fullmatch(r"(layer\d)_(\d+)\.(.+)", rest)
    if not m:
        return rest                                   # backbone.conv1.weight, bn1.*
    stage, block, tail = m.groups()
    tail = tail.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
    return f"{stage}.{block}.{tail}"


@pytest.fixture(scope="module")
def jax_variables():
    model = j_create(JModelConfig(**CFG), C)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))


def port_model(variables):
    model = create_retinanet(ModelConfig(**CFG), C, device="cpu")
    load_jax_variables(model, variables)
    return model


def reference_state_dict(backbone_only: bool, seed: int) -> dict:
    r = np.random.RandomState(seed)
    model = create_retinanet(ModelConfig(**CFG), C, device="cpu")
    sd = {}
    for name, t in model.state_dict().items():
        if backbone_only and not name.startswith("backbone."):
            continue
        val = r.randn(*t.shape).astype(np.float32)
        if name.endswith("running_var"):
            val = np.abs(val) + 0.1
        sd[reference_key(name)] = val
    sd["bn1.num_batches_tracked"] = np.array(100)
    if backbone_only:
        sd["fc.weight"] = r.randn(1000, 512).astype(np.float32)
        sd["fc.bias"] = r.randn(1000).astype(np.float32)
    return sd


def assert_same_model(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_load_pretrained_backbone_matches_jax(tmp_path, jax_variables, fmt, capsys):
    sd = reference_state_dict(backbone_only=True, seed=0)
    path = str(tmp_path / f"resnet18.{fmt}")
    if fmt == "npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    want = port_model(jax.tree.map(np.asarray, jconvert.load_pretrained_backbone(jax_variables, path)))
    got = port_model(jax_variables)
    tconvert.load_pretrained_backbone(got, path)
    assert_same_model(got, want)
    assert "skipped 3 (bn1.num_batches_tracked, fc.weight, fc.bias)" in capsys.readouterr().out
    # the head and the FPN are untouched
    assert torch.equal(got.fpn.p6.weight, port_model(jax_variables).fpn.p6.weight)


def test_load_pretrained_backbone_is_strict(tmp_path, jax_variables):
    sd = reference_state_dict(backbone_only=True, seed=1)
    sd.pop("layer2.0.downsample.1.running_var")
    np.savez(str(tmp_path / "partial.npz"), **sd)
    with pytest.raises(ValueError, match="uninitialized.*downsample_bn.running_var"):
        tconvert.load_pretrained_backbone(port_model(jax_variables), str(tmp_path / "partial.npz"))
    sd = reference_state_dict(backbone_only=True, seed=1)
    sd["conv1.weight"] = sd["conv1.weight"][:32]
    np.savez(str(tmp_path / "shape.npz"), **sd)
    with pytest.raises(ValueError, match="shape mismatch for conv1.weight"):
        tconvert.load_pretrained_backbone(port_model(jax_variables), str(tmp_path / "shape.npz"))


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_load_reference_checkpoint_matches_jax(tmp_path, jax_variables, fmt):
    sd = reference_state_dict(backbone_only=False, seed=2)
    path = str(tmp_path / f"voc2007_checkpoint_30.{fmt}")
    if fmt == "npz":
        np.savez(path, **sd)
    else:
        torch.save({"epoch": 30, "model_state_dict": {
            k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
    want = port_model(jax.tree.map(np.asarray, jconvert.load_reference_checkpoint(jax_variables, path)))
    got = port_model(jax_variables)
    tconvert.load_reference_checkpoint(got, path)
    assert_same_model(got, want)


def test_load_reference_checkpoint_strictness(tmp_path, jax_variables, capsys):
    sd = reference_state_dict(backbone_only=False, seed=3)
    sd["fpn.P5_upsampled.extra"] = np.zeros(2, np.float32)     # named, not fatal
    np.savez(str(tmp_path / "extra.npz"), **sd)
    tconvert.load_reference_checkpoint(port_model(jax_variables), str(tmp_path / "extra.npz"))
    assert "fpn.P5_upsampled.extra" in capsys.readouterr().out
    sd.pop("regressionModel.output.bias")
    np.savez(str(tmp_path / "partial.npz"), **sd)
    with pytest.raises(ValueError, match="uninitialized"):
        tconvert.load_reference_checkpoint(port_model(jax_variables), str(tmp_path / "partial.npz"))
    model = port_model(jax_variables)
    before = model.regression_head.output.bias.clone()
    tconvert.load_reference_checkpoint(model, str(tmp_path / "partial.npz"), strict=False)
    assert torch.equal(model.regression_head.output.bias, before)
    assert torch.equal(model.fpn.p6.weight, torch.from_numpy(sd["fpn.P6.weight"]))


class _NotATensor:
    """Module-level so pickle can round-trip it (weights_only rejects it)."""


def test_pickle_gate(tmp_path):
    pt = str(tmp_path / "sketchy.pt")
    torch.save({"model_state_dict": {"x": torch.zeros(2)}, "extra": _NotATensor()}, pt)
    with pytest.raises(ValueError, match="allow_pickle"):
        tconvert._load_state_dict(pt)
    assert "x" in tconvert._load_state_dict(pt, allow_pickle=True)
    npz = str(tmp_path / "converted.npz")
    with pytest.raises(ValueError, match="allow_pickle"):
        tconvert.torch_to_npz(pt, npz)
    tconvert.torch_to_npz(pt, npz, allow_pickle=True)
    assert set(np.load(npz).files) == {"x"}


def _reference_optimizer_checkpoint(path, sd, seed):
    """The reference's artifact: model_state_dict + a two-group Adam
    (group 1 the classification output conv) + a MultiStepLR state."""
    r = np.random.RandomState(seed)
    names = [k for k in sd if not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))]
    g0 = [n for n in names if "classificationModel.output" not in n]
    g1 = [n for n in names if "classificationModel.output" in n]
    order = g0 + g1
    state = {}
    for i, n in enumerate(order):
        if i % 7 == 3:
            continue                          # a parameter Adam never stepped
        state[i] = {"step": torch.tensor(float(12 + i % 3)),
                    "exp_avg": torch.from_numpy(r.randn(*sd[n].shape).astype(np.float32) * 1e-3),
                    "exp_avg_sq": torch.from_numpy(np.abs(r.randn(*sd[n].shape)).astype(np.float32) * 1e-6)}
    groups = [{"lr": 1e-5, "params": list(range(len(g0)))},
              {"lr": 1e-5, "params": list(range(len(g0), len(order)))}]
    torch.save({"model_state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "optimizer_state_dict": {"state": state, "param_groups": groups},
                "scheduler_state_dict": {"_last_lr": [1e-6, 1e-6]}}, path)


def _optax_group_state(opt_state):
    """optax's multi_transform state -> the bridge's per-group form."""

    def drop(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: drop(x) for k, x in tree.items() if not isinstance(x, optax.MaskedNode)}
        return {k: x for k, x in out.items() if not (isinstance(x, dict) and not x)}

    out = {}
    for name, masked in opt_state[0].inner_states.items():
        inject = masked.inner_state
        adam = inject.inner_state[0]
        out[name] = {"count": np.asarray(adam.count),
                     **{k: np.asarray(x) for k, x in inject.hyperparams.items()},
                     "mu": jax.tree.map(np.asarray, drop(adam.mu)),
                     "nu": jax.tree.map(np.asarray, drop(adam.nu))}
    return out


def test_load_reference_optimizer_matches_jax(tmp_path, jax_variables):
    sd = reference_state_dict(backbone_only=False, seed=4)
    path = str(tmp_path / "voc2007_checkpoint_12.pt")
    _reference_optimizer_checkpoint(path, sd, seed=5)
    params = jax.tree.map(jnp.asarray, jax_variables["params"])
    tx = j_make_optimizer(JScheduleConfig(), params, use_clip=False)
    j_state, j_info = jconvert.load_reference_optimizer(tx.init(params), params, path)
    want_model = port_model(jax_variables)
    want = make_optimizer(ScheduleConfig(), want_model)
    load_optax_state(want_model, want, _optax_group_state(j_state))

    got_model = port_model(jax_variables)
    got = make_optimizer(ScheduleConfig(), got_model)
    info = tconvert.load_reference_optimizer(got_model, got, path)
    assert (info["step"], info["last_lr"], info["loaded"]) == \
        (j_info["step"], j_info["last_lr"], j_info["loaded"])
    wsd, gsd = want.state_dict(), got.state_dict()
    for gw, gg in zip(wsd["param_groups"], gsd["param_groups"]):
        assert (gg["name"], gg["count"]) == (gw["name"], gw["count"])
        # the bridge carries optax's float32 hyperparameters
        assert [gg["lr"], *gg["betas"]] == pytest.approx([gw["lr"], *gw["betas"]], rel=1e-7)
    assert set(gsd["state"]) == set(wsd["state"])
    for i in wsd["state"]:
        for m in ("mu", "nu"):
            assert torch.equal(gsd["state"][i][m], wsd["state"][i][m]), (i, m)


def test_load_reference_optimizer_refuses_a_model_only_file(tmp_path, jax_variables):
    path = str(tmp_path / "model_only.pt")
    torch.save({"model_state_dict": {"x": torch.zeros(1)}}, path)
    model = port_model(jax_variables)
    with pytest.raises(ValueError, match="no optimizer_state_dict"):
        tconvert.load_reference_optimizer(model, make_optimizer(ScheduleConfig(), model), path)


def test_trainer_seeds_from_pretrained_and_torch_ckpt(tmp_path):
    """``ModelConfig.pretrained`` and ``TrainConfig.torch_ckpt`` (the CLI's
    --pretrained / --torch_ckpt) seed ILTrainer's model through these
    loaders; --torch_ckpt with --start_epoch > 1 also carries the Adam
    state."""
    from cl_object_detection_tpu_torch import config as tcfg
    from cl_object_detection_tpu_torch.train.trainer import ILTrainer
    from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

    json_path = make_toy_dataset(str(tmp_path / "toy"), num_images=4, classes=("a", "b", "c"),
                                 image_size=(48, 64), seed=0)
    images = str(tmp_path / "toy" / "images")
    base = tcfg.TrainConfig(model=tcfg.ModelConfig(**CFG), il=tcfg.ILConfig(scenario=("3",)),
                            data=tcfg.DataConfig(height=64, width=64, min_side=48, max_side=64),
                            checkpoint_dir=str(tmp_path / "ckpt"), record=False)
    bb = reference_state_dict(backbone_only=True, seed=6)
    np.savez(str(tmp_path / "bb.npz"), **bb)
    tr = ILTrainer(base.replace(model=tcfg.ModelConfig(**CFG, pretrained=str(tmp_path / "bb.npz"))),
                   json_path, images, workdir=str(tmp_path), device="cpu")
    assert torch.equal(tr.model.backbone.layer1_0.conv1.weight,
                       torch.from_numpy(bb["layer1.0.conv1.weight"]))

    sd = reference_state_dict(backbone_only=False, seed=7)
    pt = str(tmp_path / "ref.pt")
    _reference_optimizer_checkpoint(pt, sd, seed=8)
    tr = ILTrainer(base.replace(torch_ckpt=pt, start_epoch=3), json_path, images,
                   workdir=str(tmp_path), device="cpu")
    assert torch.equal(tr.model.classification_head.output.weight,
                       torch.from_numpy(sd["classificationModel.output.weight"]))
    assert [g["count"] for g in tr.optimizer.param_groups] == [14, 14]
    assert [g["lr"] for g in tr.optimizer.param_groups] == pytest.approx([1e-6, 1e-6])
