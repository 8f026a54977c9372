"""Pruned models in the port, and the bf16 flagship against the JAX
package's bf16, at identical weights.

A seeded small JAX Video-XProtoNet (8 frames at 32x32, P=8, D=32, K=4) is
pruned with ``protoasnet_tpu/models/surgery.py::prune_prototypes`` to P=6,
which is not a multiple of K: the port builds that shape (its readout init
writes a zero kernel, as the JAX init does), takes the pruned params through
``load_jax_variables`` and agrees with the JAX forward at fp32 (rtol=1e-3,
atol=1e-4, the backbone-parity tolerance). Its serving bundle saves and
loads. The bf16 pair runs the unpruned model in both packages with
``dtype: bfloat16``: logits within one bf16 step, sim01 within 1e-3.
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
from protoasnet_tpu.models.surgery import prune_prototypes
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.models.layers import prototype_class_identity
from protoasnet_tpu_torch.serve import (load_serving_bundle,
                                        make_serving_fn, save_serving_bundle)
from torch_port_isolation import isolated

_isolated = isolated(1)

CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (8, 32, 1, 1, 1),
       "num_classes": 4, "img_size": 32}
PRUNED = dict(CFG, prototype_shape=(6, 32, 1, 1, 1))
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def jax_pair():
    """(x, params, batch stats) of the seeded unpruned JAX model."""
    x = np.random.default_rng(0).normal(
        size=(2, 8, 32, 32, 3)).astype(np.float32)
    params, stats = init_model(jax_build_model(CFG), jnp.asarray(x[:1]),
                               seed=0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray,  # noqa: E731
                                             jax.device_get(t))
    return x, to_np(params), to_np(stats)


@pytest.fixture(scope="module")
def pruned(jax_pair):
    """(x, pruned params, stats, kept indices)."""
    x, params, stats = jax_pair
    new_params, ident, keep = prune_prototypes(params, jax_identity(8, 4),
                                               [1, 5])
    assert ident.shape == (6, 4) and keep == [0, 2, 3, 4, 6, 7]
    return x, jax.tree_util.tree_map(np.asarray, new_params), stats, keep


def _jax_forward(cfg, params, stats, x):
    return jax_build_model(cfg).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False)


def test_pruned_model_builds_with_a_zero_readout():
    model = build_model(PRUNED, device="cpu")
    assert tuple(model.prototype_vectors.shape) == (6, 32)
    assert not model.last_layer.Dense_0.weight.any()
    # the identity helper keeps refusing uneven counts for its callers
    with pytest.raises(ValueError, match="divisible"):
        prototype_class_identity(6, 4)


def test_pruned_model_matches_jax(pruned):
    x, params, stats, _ = pruned
    jl, js, _ = _jax_forward(PRUNED, params, stats, x)
    tm = load_jax_variables(build_model(PRUNED, device="cpu"), params, stats)
    with torch.no_grad():
        tl, ts, to = tm(torch.from_numpy(x))
    assert tuple(ts.shape) == (2, 6) and to.shape[-1] == 6
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL, err_msg="logits")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL, err_msg="sim01")


def test_pruned_bundle_saves_and_loads(pruned, tmp_path):
    x, params, stats, _ = pruned
    tm = load_jax_variables(build_model(PRUNED, device="cpu"), params, stats)
    path = str(tmp_path / "pruned.zip")
    save_serving_bundle(path, tm, PRUNED, (8, 32, 32, 3))
    fn = load_serving_bundle(path, device="cpu")
    # bit for bit what the pruned model serves (the served R(2+1)D trunk
    # sums the stem's products in another order than the model's forward:
    # tests/test_torch_port_aligned_trunk.py holds the two together)
    np.testing.assert_allclose(fn(x), make_serving_fn(tm)(x), rtol=0, atol=0)


def test_bf16_flagship_matches_jax_bf16(jax_pair):
    """Both packages in bf16 on the same weights: the logits within one
    bf16 step, sim01 (fp32 from both heads) within 1e-3."""
    x, params, stats = jax_pair
    cfg = dict(CFG, dtype="bfloat16")
    jl, js, _ = _jax_forward(cfg, params, stats, x)
    tm = load_jax_variables(build_model(cfg, device="cpu"), params, stats)
    with torch.no_grad():
        tl, ts, _ = tm(torch.from_numpy(x))
    # the bf16 trunk and readout sum in another order than XLA's: a logit
    # may land one bf16 step (at most 2^-7 of its magnitude) away
    jl_b = np.asarray(jl, np.float32)
    tl_b = tl.bfloat16().float().numpy()
    step = 2.0 ** -7 * np.abs(jl_b).max()
    assert np.abs(tl_b - jl_b).max() <= step, (tl_b, jl_b)
    np.testing.assert_allclose(ts.float().numpy(),
                               np.asarray(js, np.float32), rtol=0, atol=1e-3)
