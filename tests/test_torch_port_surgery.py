"""Prototype pruning in the port (``models/surgery.py``) against the JAX
package's ``models/surgery.py``, and the ImageNet preprocessing helpers
(``utils/preprocess.py``) against the JAX package's.

The same seeded weights (a JAX init carried across by ``from_jax``) are
pruned by both at the same indices, for a small video XProtoNet (8 frames
of 32x32, P=8, D=32, K=4: the occurrence module's last Linear is cut
too) and ProtoPNet (64x64 images, P=6, K=3): the same new class identity
and kept indices, and logits equal at ``rtol=1e-3, atol=1e-4`` (the
backbone-parity tolerance). The pruned model is a copy: the original
keeps its prototypes. Pruning every prototype raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.models.layers import \
    prototype_class_identity as jax_identity
from protoasnet_tpu.models.surgery import prune_prototypes as jax_prune
from protoasnet_tpu.utils import preprocess as jax_pre
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.models.surgery import prune_prototypes
from protoasnet_tpu_torch.utils import preprocess
from torch_port_isolation import isolated

_isolated = isolated(1)

VIDEO = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
         "backbone_last_layer_num": -3, "prototype_shape": (8, 32, 1, 1, 1),
         "num_classes": 4, "img_size": 32}
PPNET = {"name": "ProtoPNet", "base_architecture": "resnet18",
         "prototype_shape": (6, 32, 1, 1), "num_classes": 3, "img_size": 64,
         "add_on_layers_type": "regular"}
CASES = {"video": (VIDEO, (2, 8, 32, 32, 3), [1, 5]),
         "ppnet": (PPNET, (2, 64, 64, 3), [0, 4])}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pruning_matches_the_jax_package(case):
    cfg, shape, drop = CASES[case]
    p, k = cfg["prototype_shape"][0], cfg["num_classes"]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    params, stats = init_model(jax_build_model(cfg), jnp.asarray(x[:1]),
                               seed=0)
    params, stats = _np(params), _np(stats)
    ident = jax_identity(p, k)
    jparams, jident, jkeep = jax_prune(params, ident, drop)
    pruned_cfg = dict(cfg, prototype_shape=(p - len(drop),
                                            *cfg["prototype_shape"][1:]))
    jlogits = jax_build_model(pruned_cfg).apply(
        {"params": _np(jparams), "batch_stats": stats}, jnp.asarray(x),
        train=False)[0]

    model = load_jax_variables(build_model(cfg, device="cpu"), params, stats)
    before = model.prototype_vectors.detach().clone()
    pruned, tident, tkeep = prune_prototypes(model, ident, drop)
    assert tkeep == jkeep
    np.testing.assert_array_equal(tident, jident)
    assert pruned.prototype_shape == tuple(pruned_cfg["prototype_shape"])
    assert pruned.prototype_vectors.device == model.prototype_vectors.device
    assert torch.equal(model.prototype_vectors, before)  # a copy
    with torch.no_grad():
        logits = pruned.eval()(torch.from_numpy(x))[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-3, atol=1e-4)
    # the pruned model's weights are the JAX package's pruned tree
    ref = load_jax_variables(build_model(pruned_cfg, device="cpu"),
                             _np(jparams), stats).state_dict()
    for name, val in pruned.state_dict().items():
        assert torch.equal(val, ref[name]), name


def test_pruning_every_prototype_raises():
    model = build_model(VIDEO, device="cpu")
    with pytest.raises(ValueError, match="all prototypes"):
        prune_prototypes(model, jax_identity(8, 4), range(8))


@pytest.mark.parametrize("fn", ["preprocess_input_function",
                                "undo_preprocess_input_function"])
def test_preprocess_matches_the_jax_package(fn):
    x = np.random.default_rng(2).uniform(size=(2, 5, 7, 3)).astype(
        np.float32)
    got = getattr(preprocess, fn)(torch.from_numpy(x))
    ref = np.asarray(getattr(jax_pre, fn)(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert preprocess.IMAGENET_MEAN == jax_pre.IMAGENET_MEAN
    assert preprocess.IMAGENET_STD == jax_pre.IMAGENET_STD
    back = preprocess.undo_preprocess_input_function(
        preprocess.preprocess_input_function(torch.from_numpy(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-6)
