"""Port's 2-D models against the JAX package's at identical weights.

The JAX ``ResNetFeatures``, ``PPNet`` and image ``XProtoNet`` are
initialised with ``init_model``, their BN running stats are replaced by
random non-trivial ones, and the trees go through ``load_jax_variables``
into the port. Outputs then agree at fp32 within the backbone-parity
tolerance of tests/test_torch_port_model.py (rtol=1e-3, atol=1e-4).
Small shapes: 64x64 images, P=6, D=64, K=3 for PPNet (as in
tests/test_pallas_roi.py) and P=8, D=64, K=4 for XProtoNet. The JAX PPNet
runs both its heads: ``head_impl="xla"`` and ``"pallas"``, the Pallas
kernel in interpret mode on the CPU as its own tests run it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.models.backbones.resnet2d import \
    ResNetFeatures as JaxResNetFeatures
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu_torch.models.backbones import ResNetFeatures, make_backbone
from protoasnet_tpu_torch.models.builder import build_model, example_input
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.models.layers import (BottleneckAddOn,
                                                bottleneck_channel_plan)

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4
IMG = 64
PPNET = {"name": "ProtoPNet", "base_architecture": "resnet18",
         "prototype_shape": (6, 64, 1, 1), "num_classes": 3, "img_size": IMG,
         "prototype_activation_function": "log",
         "add_on_layers_type": "regular", "head_impl": "xla"}
XPROTO = {"name": "XProtoNet", "base_architecture": "resnet18",
          "prototype_shape": (8, 64, 1, 1), "num_classes": 4,
          "img_size": IMG, "head_impl": "xla"}


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


def _images(n=2, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, IMG, IMG, 3)).astype(np.float32)


def _jax_variables(module, x, seed):
    params, stats = init_model(module, jnp.asarray(x[:1]), seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    stats = _random_stats(jax.device_get(stats), np.random.default_rng(seed))
    return {"params": params, "batch_stats": stats}


def _close(port_t, jax_a, name):
    np.testing.assert_allclose(port_t.detach().float().numpy(),
                               np.asarray(jax_a), rtol=RTOL, atol=ATOL,
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def _ppnet_pair(add_on: str, proto_hw: int = 1):
    """(jax config, variables, port model) for one add-on type and
    prototype size; shared by the tests below."""
    cfg = dict(PPNET, add_on_layers_type=add_on,
               prototype_shape=(6, 64, proto_hw, proto_hw))
    variables = _jax_variables(jax_build_model(cfg), _images(), seed=1)
    tm = build_model(cfg, device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return cfg, variables, tm


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_trunk_matches_jax(name):
    """BasicBlock (18) and Bottleneck (50) trunks: (N, H, W, 3) NHWC in the
    JAX package, NCHW in the port."""
    x = _images(seed=2)[:, :32, :32] if name == "resnet50" else _images()
    jm = JaxResNetFeatures(block_name=name)
    variables = _jax_variables(jm, x, seed=3)
    tm = make_backbone(name).eval()
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    jy = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        ty = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tm.out_channels == jy.shape[-1]
    assert tuple(ty.shape) == tuple(jy.shape)
    _close(ty, jy, f"{name} features")
    assert tm.conv_info() == jm.conv_info()


@pytest.mark.parametrize("activation", ["log", "linear"])
@pytest.mark.parametrize("jax_head", ["xla", "pallas"])
@pytest.mark.parametrize("add_on", ["regular", "bottleneck"])
def test_ppnet_forward_matches_jax(add_on, jax_head, activation):
    cfg, variables, tm = _ppnet_pair(add_on)
    cfg = dict(cfg, head_impl=jax_head,
               prototype_activation_function=activation)
    x = _images(seed=4)
    jl, jd = jax_build_model(cfg).apply(variables, jnp.asarray(x))
    tm.prototype_activation_function = activation
    with torch.no_grad():
        tl, td = tm(torch.from_numpy(x))
    assert tuple(td.shape) == (2, 6) and td.dtype == torch.float32
    _close(td, jd, "min_distances")
    _close(tl, jl, "logits")


@pytest.mark.parametrize("jax_head", ["xla", "pallas"])
@pytest.mark.parametrize("add_on", ["regular", "bottleneck"])
def test_ppnet_push_forward_matches_jax(add_on, jax_head):
    cfg, variables, tm = _ppnet_pair(add_on)
    jm = jax_build_model(dict(cfg, head_impl=jax_head))
    x = _images(seed=5)
    jc, jd = jm.apply(variables, jnp.asarray(x), method=jm.push_forward)
    with torch.no_grad():
        tc, td = tm.push_forward(torch.from_numpy(x))
    assert tuple(tc.shape) == (2, 2, 2, 64) and tuple(td.shape) == (2, 2, 2, 6)
    _close(tc, jc, "conv_features")
    _close(td, jd, "distances")


def test_ppnet_2x2_prototypes_take_the_conv_path():
    """A (kh, kw) = (2, 2) prototype goes through l2_patch_distances'
    general conv path in both packages."""
    cfg, variables, tm = _ppnet_pair("regular", proto_hw=2)
    assert tuple(tm.prototype_vectors.shape) == (6, 2, 2, 64)
    jm = jax_build_model(cfg)
    x = _images(seed=6)
    jl, jd = jm.apply(variables, jnp.asarray(x))
    jc, jmap = jm.apply(variables, jnp.asarray(x), method=jm.push_forward)
    with torch.no_grad():
        tl, td = tm(torch.from_numpy(x))
        _, tmap = tm.push_forward(torch.from_numpy(x))
    assert tuple(tmap.shape) == (2, 1, 1, 6)
    _close(td, jd, "min_distances")
    _close(tl, jl, "logits")
    _close(tmap, jmap, "distances")


def test_ppnet_readout_and_prototypes_init():
    tm = build_model(PPNET, device="cpu", seed=5)
    w = tm.last_layer.Dense_0.weight  # (K, P)
    assert set(w.unique().tolist()) == {-0.5, 1.0}
    assert (w.T.argmax(1) == torch.arange(6) // 2).all()
    pv = tm.prototype_vectors
    assert tuple(pv.shape) == (6, 1, 1, 64)
    assert 0.0 <= pv.min() and pv.max() <= 1.0


def test_bottleneck_add_on_matches_jax_plan():
    from protoasnet_tpu.models import layers as jl

    for cin, cout in ((512, 64), (512, 512), (512, 300), (2048, 128)):
        assert bottleneck_channel_plan(cin, cout) == list(
            jl.bottleneck_channel_plan(cin, cout))
    m = BottleneckAddOn(512, 64)
    assert m.n_layers == 6 and m.Dense_5.out_features == 64
    x = torch.randn(2, 3, 512)
    with torch.no_grad():
        y = m(x)
        assert ((y > 0) & (y < 1)).all()  # final Sigmoid
        md = BottleneckAddOn(512, 64, drop_final_activation=True)
        md.load_state_dict(m.state_dict())
        torch.testing.assert_close(torch.sigmoid(md(x)), y)


@pytest.fixture(scope="module")
def xproto_pair():
    x = _images(seed=7)
    jm = jax_build_model(XPROTO)
    variables = _jax_variables(jm, x, seed=8)
    tm = build_model(XPROTO, device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return jm, variables, tm, x


def test_image_xprotonet_forward_matches_jax(xproto_pair):
    jm, variables, tm, x = xproto_pair
    jl, js, jo = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        tl, ts, to = tm(torch.from_numpy(x))
    assert tuple(to.shape) == (2, 2, 2, 8)  # channels-last (N, H', W', P)
    _close(tl, jl, "logits")
    _close(ts, js, "sim01")
    _close(to, jo, "occurrence")


def test_image_xprotonet_push_and_occurrence_match_jax(xproto_pair):
    jm, variables, tm, x = xproto_pair
    jr, jd, jo, jl = jm.apply(variables, jnp.asarray(x),
                              method=jm.push_forward)
    jocc = jm.apply(variables, jnp.asarray(x),
                    method=jm.compute_occurrence_map)
    with torch.no_grad():
        tr, td, to, tl = tm.push_forward(torch.from_numpy(x))
        tocc = tm.compute_occurrence_map(torch.from_numpy(x))
    _close(tr, jr, "roi")
    _close(td, jd, "1 - sim01")
    _close(tl, jl, "logits")
    _close(tocc, jocc, "occurrence")


def test_image_models_build_at_full_width():
    from pathlib import Path

    from protoasnet_tpu_torch.utils.config import load_config

    root = Path(__file__).resolve().parents[1] / "protoasnet_tpu" / "configs"
    for name, proto, k in (("baseline_protopnet.yml", (30, 1, 1, 512), 3),
                           ("baseline_protopnet_e2e.yml", (30, 1, 1, 512), 3),
                           ("ours_protoasnet_image.yml", (40, 512), 4)):
        cfg = load_config(str(root / name))
        model = build_model(cfg["model"], device="cpu")
        assert isinstance(model.features if cfg["model"]["name"] ==
                          "ProtoPNet" else model.cnn_backbone,
                          ResNetFeatures)
        assert tuple(model.prototype_vectors.shape) == proto
        assert model.last_layer.Dense_0.weight.shape == (k, proto[0])
        x = example_input(cfg["model"], cfg["data"], device="cpu")
        assert tuple(x.shape) == (1, 224, 224, 3)
