"""Port's Video-XProtoNet against the JAX package's at identical weights.

The JAX ``XProtoNet(head_impl="xla")`` is initialised with ``init_model``,
its BN running stats are replaced by random non-trivial ones, and the
trees go through ``load_jax_variables`` into the port. ``forward``,
``push_forward`` and ``compute_occurrence_map`` then agree at fp32 within
the backbone-parity tolerance of tests/test_torch_import.py
(rtol=1e-3, atol=1e-4). Small shapes: 8 frames at 32x32, P=8, D=64, K=4.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu_torch.models.builder import build_model, example_input
from protoasnet_tpu_torch.models.from_jax import (jax_to_state_dict,
                                                  load_jax_variables)
from protoasnet_tpu_torch.models.layers import (incorrect_connection_kernel,
                                                prototype_class_identity)
from protoasnet_tpu_torch.utils.config import (apply_overrides, load_config,
                                               parse_prototype_shape)

torch.set_num_threads(1)

P, D, K = 8, 64, 4
CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (P, D, 1, 1, 1),
       "num_classes": K, "img_size": 32, "head_impl": "xla"}
RTOL, ATOL = 1e-3, 1e-4


def _random_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(scale=0.2, size=v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(jax model, variables, port model, input clips)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 32, 32, 3)).astype(np.float32)
    jm = jax_build_model(CFG)
    params, stats = init_model(jm, jnp.asarray(x[:1]), seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    stats = _random_stats(jax.device_get(stats), rng)
    tm = build_model(CFG, device="cpu")
    load_jax_variables(tm, params, stats)
    return jm, {"params": params, "batch_stats": stats}, tm, x


def _close(port_t, jax_a, name):
    np.testing.assert_allclose(port_t.detach().numpy(), np.asarray(jax_a),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def test_forward_matches_jax(pair):
    jm, variables, tm, x = pair
    jl, js, jo = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        tl, ts, to = tm(torch.from_numpy(x))
    assert to.shape == (2, 2, 4, 4, P)  # channels-last occurrence
    _close(tl, jl, "logits")
    _close(ts, js, "sim01")
    _close(to, jo, "occurrence")


def test_push_forward_matches_jax(pair):
    jm, variables, tm, x = pair
    jr, jd, jo, jl = jm.apply(variables, jnp.asarray(x),
                              method=jm.push_forward)
    with torch.no_grad():
        tr, td, to, tl = tm.push_forward(torch.from_numpy(x))
    assert tr.shape == (2, P, D)
    _close(tr, jr, "roi")
    _close(td, jd, "1 - sim01")
    _close(to, jo, "occurrence")
    _close(tl, jl, "logits")


def test_compute_occurrence_map_matches_jax(pair):
    jm, variables, tm, x = pair
    jo = jm.apply(variables, jnp.asarray(x),
                  method=jm.compute_occurrence_map)
    with torch.no_grad():
        to = tm.compute_occurrence_map(torch.from_numpy(x))
    assert (to >= 0).all()
    _close(to, jo, "occurrence")


def test_bf16_forward_tracks_fp32(pair):
    """dtype bfloat16 runs convs and Linears under bf16 autocast; the head
    still returns fp32 and the logits stay near the fp32 ones."""
    _, _, tm, x = pair
    tb = build_model(dict(CFG, dtype="bfloat16"), device="cpu")
    tb.load_state_dict(tm.state_dict())
    with torch.no_grad():
        l32, s32, _ = tm(torch.from_numpy(x))
        l16, s16, o16 = tb(torch.from_numpy(x))
    assert o16.dtype == torch.bfloat16
    assert s16.dtype == torch.float32
    assert torch.isfinite(l16).all()
    # bf16 keeps ~3 significant digits through 17 conv layers
    np.testing.assert_allclose(s16.float().numpy(), s32.numpy(), atol=5e-2)


@pytest.mark.parametrize("mutation", ["missing", "extra"])
def test_bridge_fails_on_key_mismatch(pair, mutation):
    _, variables, _, _ = pair
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    if mutation == "missing":
        del params["occurrence_module"]["Dense_2"]
        key = "missing ['occurrence_module.Dense_2.weight']"
    else:
        params["occurrence_module"]["Dense_3"] = {
            "kernel": np.zeros((D // 2, P), np.float32)}
        key = "extra ['occurrence_module.Dense_3.weight']"
    with pytest.raises(KeyError, match=re.escape(key)):
        load_jax_variables(build_model(CFG, device="cpu"), params,
                           variables["batch_stats"])


def test_bridge_fails_on_shape_mismatch(pair):
    _, variables, _, _ = pair
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    params["prototype_vectors"] = np.zeros((P + 1, D), np.float32)
    with pytest.raises(ValueError, match="prototype_vectors"):
        load_jax_variables(build_model(CFG, device="cpu"), params,
                           variables["batch_stats"])


def test_bridge_layouts():
    params = {"c": {"kernel": np.arange(2 * 3 * 4 * 5 * 6).reshape(
        2, 3, 4, 5, 6)}, "l": {"kernel": np.ones((5, 7)),
                              "bias": np.zeros(7)},
              "bn": {"scale": np.ones(3), "bias": np.zeros(3)}}
    sd = jax_to_state_dict(params, {"bn": {"mean": np.zeros(3),
                                           "var": np.ones(3)}})
    assert sd["c.weight"].shape == (6, 5, 2, 3, 4)
    assert sd["c.weight"][1, 2, 0, 1, 3] == params["c"]["kernel"][0, 1, 3,
                                                                   2, 1]
    assert sd["l.weight"].shape == (7, 5)
    assert set(sd) == {"c.weight", "l.weight", "l.bias", "bn.weight",
                       "bn.bias", "bn.running_mean", "bn.running_var"}


def test_layers_match_jax_helpers():
    from protoasnet_tpu.models import layers as jl

    np.testing.assert_array_equal(prototype_class_identity(40, 4),
                                  jl.prototype_class_identity(40, 4))
    np.testing.assert_array_equal(
        incorrect_connection_kernel(40, 4, -0.5),
        jl.incorrect_connection_kernel(40, 4, -0.5))


def test_flagship_config_builds_at_full_width():
    cfg = load_config(str(Path(__file__).resolve().parents[1] / "protoasnet_tpu"
                          / "configs" / "ours_protoasnet_video.yml"))
    assert parse_prototype_shape(cfg["model"]["prototype_shape"]) == (
        40, 256, 1, 1, 1)
    cfg = apply_overrides(cfg, ["--model.dtype=float32"])
    model = build_model(cfg["model"], device="cpu")
    assert model.cnn_backbone.out_channels == 256
    assert tuple(model.prototype_vectors.shape) == (40, 256)
    assert model.last_layer.Dense_0.weight.shape == (4, 40)
    x = example_input(cfg["model"], cfg["data"], device="cpu")
    assert tuple(x.shape) == (1, 32, 112, 112, 3)


def test_bad_model_configs_raise():
    with pytest.raises(ValueError, match="video backbone"):
        build_model(dict(CFG, base_architecture="resnet18"), device="cpu")
    with pytest.raises(ValueError, match="unknown model name"):
        build_model(dict(CFG, name="PPNet"), device="cpu")
    with pytest.raises(ValueError, match="Unknown base_architecture"):
        build_model(dict(CFG, name="XProtoNet", base_architecture="vgg10"),
                    device="cpu")


def test_config_override_parsing_matches_jax():
    from protoasnet_tpu.utils import config as jc
    from protoasnet_tpu_torch.utils import config as tc

    for raw in ["true", "None", "3", "1e-4", "(40, 256, 1, 1, 1)", "[1, 2]",
                "adam"]:
        assert tc.parse_value(raw) == jc.parse_value(raw), raw
    with pytest.raises(KeyError):
        apply_overrides({"a": {"b": 1}}, ["--a.c=2"])
