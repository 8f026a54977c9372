"""``pretrained: true`` in the port: local torchvision weights load into
the trunk, and without them the random init stays (nothing is fetched).

The torchvision state dict is written by the JAX package's own exporters
(``export_r2plus1d``, ``export_resnet2d``) from a JAX model's trunk, so the
port's renaming is held against the JAX package's mapping: the loaded trunk
must equal the one ``load_jax_variables`` gives from the same trees. For
r3d_18, VGG and DenseNet the state dict is the torchvision-layout twin of
``tests/test_torch_import.py`` (``TVR3D``, ``TVVGG``, ``TVDenseLayer``):
the loaded trunk's forward equals the twin's, and its weights equal the
JAX package's ``convert_r3d`` / ``convert_vgg`` / ``convert_densenet``
output carried over by the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.models.torch_import import (export_r2plus1d,
                                                export_resnet2d)
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.models.pretrained import load_pretrained_backbone
from tests.test_torch_import import TVR3D, TVVGG, TVDenseLayer
from torch_port_isolation import isolated

_isolated = isolated(1)

CFGS = {
    "resnet2p1d_18": ({"name": "Video_XProtoNet",
                       "base_architecture": "resnet2p1d_18",
                       "backbone_last_layer_num": -3,
                       "prototype_shape": (8, 64, 1, 1, 1), "num_classes": 4,
                       "img_size": 32}, (1, 8, 32, 32, 3)),
    "resnet18": ({"name": "XProtoNet", "base_architecture": "resnet18",
                  "prototype_shape": (8, 64, 1, 1), "num_classes": 4,
                  "img_size": 64}, (1, 64, 64, 3)),
}


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_local_torchvision_weights_load_into_the_trunk(arch, tmp_path,
                                                       monkeypatch):
    cfg, shape = CFGS[arch]
    jm = jax_build_model(cfg)
    params, stats = init_model(jm, jnp.zeros(shape), seed=1)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(stats))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        stats)
    if arch == "resnet2p1d_18":
        sd = export_r2plus1d(params["cnn_backbone"], stats["cnn_backbone"],
                             num_stages=3)
    else:
        sd = export_resnet2d(params["cnn_backbone"], stats["cnn_backbone"],
                             arch)
    sd["fc.weight"] = np.zeros((400, 8), np.float32)  # dropped: not trunk
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               tmp_path / f"{arch}.pth")
    monkeypatch.setenv("PROTOASNET_PRETRAINED_DIR", str(tmp_path))

    ref = load_jax_variables(build_model(cfg, device="cpu"), params, stats)
    model = build_model(cfg, device="cpu", seed=5)
    head_before = model.prototype_vectors.detach().clone()
    assert load_pretrained_backbone(model, dict(cfg, pretrained=True))
    got, want = model.cnn_backbone.state_dict(), \
        ref.cnn_backbone.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    assert torch.equal(model.prototype_vectors, head_before)


def test_no_local_weights_keeps_the_random_init(tmp_path, monkeypatch):
    cfg = CFGS["resnet2p1d_18"][0]
    monkeypatch.setenv("PROTOASNET_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    model = build_model(cfg, device="cpu", seed=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not load_pretrained_backbone(model, dict(cfg, pretrained=True))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def _tv_densenet121():
    """A torchvision-layout densenet121 ``features`` (the twin of
    ``tests/test_torch_import.py``) and its forward."""
    from protoasnet_tpu_torch.models.backbones.densenet import DENSENET_SPECS

    init_f, growth, blocks = DENSENET_SPECS["densenet121"]
    feats = torch.nn.Module()
    feats.conv0 = torch.nn.Conv2d(3, init_f, 7, 2, 3, bias=False)
    feats.norm0 = torch.nn.BatchNorm2d(init_f)
    c = init_f
    for i, n in enumerate(blocks):
        block = torch.nn.Module()
        for j in range(n):
            setattr(block, f"denselayer{j + 1}",
                    TVDenseLayer(c + j * growth, growth))
        setattr(feats, f"denseblock{i + 1}", block)
        c += n * growth
        if i != len(blocks) - 1:
            tr = torch.nn.Module()
            tr.norm = torch.nn.BatchNorm2d(c)
            tr.conv = torch.nn.Conv2d(c, c // 2, 1, bias=False)
            setattr(feats, f"transition{i + 1}", tr)
            c //= 2
    feats.norm5 = torch.nn.BatchNorm2d(c)
    root = torch.nn.Module()
    root.features = feats
    F = torch.nn.functional

    def forward(x):
        y = F.max_pool2d(F.relu(feats.norm0(feats.conv0(x))), 3, 2, 1)
        for i in range(len(blocks)):
            block = getattr(feats, f"denseblock{i + 1}")
            for j in range(blocks[i]):
                y = getattr(block, f"denselayer{j + 1}")(y)
            if i != len(blocks) - 1:
                tr = getattr(feats, f"transition{i + 1}")
                y = F.avg_pool2d(tr.conv(F.relu(tr.norm(y))), 2, 2)
        return F.relu(feats.norm5(y))

    return root, forward


def _twin(arch):
    """(twin module, its forward on channels-first input, input shape)."""
    if arch == "r3d_18":
        tv = TVR3D(num_stages=3)
        return tv, tv, (2, 3, 8, 32, 32)
    if arch.startswith("vgg"):
        from protoasnet_tpu.models.backbones.vgg import VGG_CFGS

        tv = TVVGG(VGG_CFGS[arch.replace("_bn", "")],
                   bn=arch.endswith("_bn"))
        return tv, tv, (2, 3, 32, 32)
    tv, forward = _tv_densenet121()
    return tv, forward, (2, 3, 32, 32)


def _jax_convert(arch, sd):
    from protoasnet_tpu.models.torch_import import (convert_densenet,
                                                    convert_r3d, convert_vgg)

    if arch == "r3d_18":
        return convert_r3d(sd, num_stages=3)
    if arch.startswith("vgg"):
        return convert_vgg(sd, arch)
    return convert_densenet(sd, arch)


@pytest.mark.parametrize("arch", ["r3d_18", "vgg11", "vgg11_bn",
                                  "densenet121"])
def test_torchvision_twins_load_into_the_new_trunks(arch, tmp_path,
                                                    monkeypatch):
    """The twins of ``tests/test_torch_import.py`` saved as ``.pth``: the
    loaded trunk's forward equals the twin's, and its weights equal the
    JAX package's ``convert_*`` output carried over by the bridge."""
    torch.manual_seed(3)
    tv, forward, shape = _twin(arch)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for m in tv.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.from_numpy(rng.normal(
                    scale=0.1, size=m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, size=m.num_features).astype(np.float32)))
    tv.eval()
    sd = dict(tv.state_dict())
    sd["fc.weight"] = torch.zeros(400, 8)  # dropped: not the trunk's
    torch.save(sd, tmp_path / f"{arch}.pth")
    monkeypatch.setenv("PROTOASNET_PRETRAINED_DIR", str(tmp_path))
    if arch == "r3d_18":
        cfg = {"name": "Video_XProtoNet", "base_architecture": arch,
               "backbone_last_layer_num": -3,
               "prototype_shape": (8, 64, 1, 1, 1), "num_classes": 4}
    else:
        cfg = {"name": "ProtoPNet", "base_architecture": arch,
               "prototype_shape": (6, 32, 1, 1), "num_classes": 3}
    model = build_model(cfg, device="cpu", seed=5)
    assert load_pretrained_backbone(model, dict(cfg, pretrained=True))
    trunk = model.cnn_backbone if arch == "r3d_18" else model.features
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(trunk(x).numpy(), forward(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
    params, stats = _jax_convert(arch, {k: v.numpy()
                                        for k, v in sd.items()})
    ref = build_model(cfg, device="cpu")
    ref_trunk = ref.cnn_backbone if arch == "r3d_18" else ref.features
    load_jax_variables(ref_trunk, params, stats)
    for k, v in ref_trunk.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(trunk.state_dict()[k], v), k
