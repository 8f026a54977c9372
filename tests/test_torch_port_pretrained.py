"""``pretrained: true`` in the port: local torchvision weights load into
the trunk, and without them the random init stays (nothing is fetched).

The torchvision state dict is written by the JAX package's own exporters
(``export_r2plus1d``, ``export_resnet2d``) from a JAX model's trunk, so the
port's renaming is held against the JAX package's mapping: the loaded trunk
must equal the one ``load_jax_variables`` gives from the same trees.
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

torch.set_num_threads(1)

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
