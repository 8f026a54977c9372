"""The port's last trunks (r3d_18, VGG, DenseNet) against the JAX
package's at identical weights.

The JAX trees come from ``jax.eval_shape`` of the JAX module's init, filled
from a numpy generator (kaiming-normal fan-out kernels, small biases, BN
scales in [0.5, 1.5]); the BN running statistics are those of one
train-mode pass of the port's model over the test input, each variance
raised by 0.5 (well conditioned: random statistics blow a DenseNet's
activations up to ~1e4, and the batch's own ones at a 1x1 map to ~1e22).
Both packages then run the same trees through ``models/from_jax.py``:

- ``r3d_18`` (8 frames of 32x32), ``vgg11``, ``vgg11_bn`` and
  ``densenet121`` (32x32): the eval forward at fp32, rtol 1e-3, atol 1e-4;
- every other name of the JAX package's ``BACKBONE_NAMES``: the port's
  ``out_channels`` and its state_dict's keys and shapes equal to the JAX
  init trees (``jax.eval_shape``, no forward);
- ``conv_info()`` equal to the JAX trunk's for every 2-D name;
- PPNet on ``vgg11_bn`` and on ``densenet121`` (64x64): logits and
  ``min_d`` at fp32, and the patch push's boxes equal;
- one float64 train micro-step of ``r3d_18`` Video_XProtoNet and of
  ``vgg11_bn`` PPNet against the JAX step (under ``jax.enable_x64``):
  loss terms to 1e-9 relative, each gradient tensor to 1e-7 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.losses.bundle import LossBundle as JaxBundle
from protoasnet_tpu.losses.losses import sample_affine_params
from protoasnet_tpu.models.backbones import BACKBONE_NAMES as JAX_NAMES
from protoasnet_tpu.models.backbones import make_backbone as jax_backbone
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.push import push_protopnet as jax_push
from protoasnet_tpu.train.optim import make_adam
from protoasnet_tpu.train.steps import TrainState, make_xprotonet_loss_fn
from protoasnet_tpu.train.steps import \
    make_protopnet_steps as jax_make_protopnet_steps
from protoasnet_tpu_torch.losses.bundle import LossBundle
from protoasnet_tpu_torch.models.backbones import (BACKBONE_NAMES,
                                                   MVIT_SPECS, SWIN3D_SPECS,
                                                   make_backbone)
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import (jax_to_state_dict,
                                                  load_jax_variables,
                                                  state_dict_to_jax)
from protoasnet_tpu_torch.models.layers import prototype_class_identity
from protoasnet_tpu_torch.push.push_protopnet import push_prototypes_patch
from protoasnet_tpu_torch.train.optim import (GROUPS, STAGE_GROUPS,
                                              GradAccumulator, GroupAdam,
                                              group_of)
from protoasnet_tpu_torch.train.steps import (make_protopnet_steps,
                                              make_xprotonet_steps)
from torch_port_isolation import isolated

_isolated = isolated(1)

RTOL, ATOL = 1e-3, 1e-4
FORWARD = ("r3d_18", "vgg11", "vgg11_bn", "densenet121")
TWO_D = tuple(n for n in JAX_NAMES if n not in ("resnet2p1d_18", "r3d_18"))


def _is_video(name):
    return name in ("resnet2p1d_18", "r3d_18")


def _filled(shapes, rng, dtype=np.float32):
    """numpy leaves for a tree of ShapeDtypeStructs (params only)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _filled(v, rng, dtype)
        elif k == "kernel" and len(v.shape) >= 3:
            fan_out = v.shape[-1] * int(np.prod(v.shape[:-2]))
            out[k] = rng.normal(scale=(2.0 / fan_out) ** 0.5, size=v.shape)
        elif k == "kernel":
            out[k] = rng.normal(scale=v.shape[0] ** -0.5, size=v.shape)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, size=v.shape)
        elif k == "prototype_vectors":
            out[k] = rng.uniform(0.0, 1.0, size=v.shape)
        else:
            out[k] = rng.normal(scale=0.05, size=v.shape)
        if not isinstance(out[k], dict):
            out[k] = np.asarray(out[k], dtype)
    return out


def _trees(jax_module, port_module, x, port_x=None, seed=0):
    """(params, batch_stats) numpy trees for ``jax_module`` (input ``x``),
    the stats from one train-mode pass of ``port_module`` over ``port_x``
    (default ``x``)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_module.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + x.shape[1:])))
    params = _filled(shapes["params"], rng)
    ones = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                  dict(shapes.get("batch_stats", {})))
    load_jax_variables(port_module, params, ones)
    bns = [m for m in port_module.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.momentum = 1.0
    port_module.train()
    with torch.no_grad():
        port_module(torch.from_numpy(x) if port_x is None else port_x)
    for m in bns:  # a floor under the small maps' batch variances
        m.momentum = 0.1
        m.running_var.add_(0.5)
    port_module.eval()
    return params, state_dict_to_jax(port_module.state_dict())[1]


def _nc(x):
    """channels-last -> channels-first."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _cl(x):
    return x.permute(0, *range(2, x.dim()), 1)


@pytest.mark.parametrize("name", FORWARD)
def test_trunk_forward_matches_jax(name):
    rng = np.random.default_rng(1)
    shape = (2, 8, 32, 32, 3) if _is_video(name) else (2, 32, 32, 3)
    x = rng.normal(size=shape).astype(np.float32)
    jm, tm = jax_backbone(name), make_backbone(name)
    params, stats = _trees(jm, tm, x, _nc(torch.from_numpy(x)))
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = _cl(tm(_nc(torch.from_numpy(x))))
    assert tuple(got.shape) == want.shape
    assert tm.out_channels == jm.out_channels == want.shape[-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_backbone_names_are_the_jax_packages():
    """The JAX package's names in its order, then the port's own
    transformer trunks, Video Swin and MViTv2 (which the JAX package does
    not have)."""
    assert BACKBONE_NAMES == tuple(JAX_NAMES) + tuple(SWIN3D_SPECS) + tuple(
        MVIT_SPECS)
    assert tuple(SWIN3D_SPECS) == ("swin3d_b",)
    assert tuple(MVIT_SPECS) == ("mvit_v2_b",)
    with pytest.raises(ValueError, match="options"):
        make_backbone("resnet9")


def _expected_state(jm, x_shape):
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros(x_shape)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        dict(shapes))
    sd = jax_to_state_dict(zeros["params"], zeros.get("batch_stats", {}))
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name", [n for n in JAX_NAMES if n not in FORWARD])
def test_trunk_tree_matches_jax(name):
    jm, tm = jax_backbone(name), make_backbone(name)
    shape = (1, 8, 32, 32, 3) if _is_video(name) else (1, 32, 32, 3)
    want = _expected_state(jm, shape)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
    assert tm.out_channels == jm.out_channels


@pytest.mark.parametrize("name", TWO_D)
def test_conv_info_matches_jax(name):
    assert tuple(make_backbone(name).conv_info()) == \
        tuple(jax_backbone(name).conv_info())


P, D, K, IMG = 6, 32, 3, 64


def _ppnet_cfg(arch):
    return {"name": "ProtoPNet", "base_architecture": arch,
            "prototype_shape": (P, D, 1, 1), "num_classes": K,
            "img_size": IMG, "add_on_layers_type": "bottleneck",
            "head_impl": "xla"}


@pytest.fixture(scope="module", params=["vgg11_bn", "densenet121"])
def ppnet(request):
    arch = request.param
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, IMG, IMG, 3)).astype(np.float32)
    jm = jax_build_model(_ppnet_cfg(arch))
    tm = build_model(_ppnet_cfg(arch), device="cpu")
    params, stats = _trees(jm, tm, x, seed=2)
    return arch, jm, {"params": params, "batch_stats": stats}, tm, x


def test_ppnet_on_the_new_trunks_matches_jax(ppnet):
    _, jm, variables, tm, x = ppnet
    jl, jd = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        tl, td = tm(torch.from_numpy(x))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_ppnet_push_boxes_on_the_new_trunks_match_jax(ppnet, tmp_path):
    arch, jm, variables, tm, x = ppnet
    batches = [{"cine": x[:2], "target_AS": np.array([0, 1], np.int32),
                "valid": np.array([True, True])},
               {"cine": x[2:], "target_AS": np.array([2, 1], np.int32),
                "valid": np.array([True, True])}]

    class _JaxModel:
        features = jax_backbone(arch)
        prototype_shape = (P, D, 1, 1)

    push_fwd = jax.jit(lambda p, s, xx: jm.apply(
        {"params": p, "batch_stats": s}, xx, train=False,
        method=jm.push_forward))
    ident = prototype_class_identity(P, K)
    _, j_info = jax_push.push_prototypes_patch(
        [dict(b, cine=jnp.asarray(b["cine"])) for b in batches], push_fwd,
        variables["params"], variables["batch_stats"], _JaxModel(),
        class_identity=ident, root_dir_for_saving_prototypes=str(
            tmp_path / "jax"), epoch_number=0, replace_prototypes=False,
        img_size=IMG, render=False)

    def push_step(cine):
        with torch.no_grad():
            return tm.eval().push_forward(cine)

    _, t_info = push_prototypes_patch(
        [dict(b, cine=torch.from_numpy(b["cine"])) for b in batches],
        push_step, tm, class_identity=ident,
        root_dir_for_saving_prototypes=str(tmp_path / "port"),
        epoch_number=0, replace_prototypes=False, img_size=IMG,
        render=False)
    np.testing.assert_array_equal(t_info["bb"], j_info["bb"])
    np.testing.assert_array_equal(t_info["bb_rf"], j_info["bb_rf"])
    np.testing.assert_array_equal(t_info["prototypes_gts"],
                                  j_info["prototypes_gts"])


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close_terms(tout, jout):
    for name, val in jout.items():
        if name == "applied" or name not in tout:
            continue
        np.testing.assert_allclose(np.asarray(tout[name]), np.asarray(val),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def _close_grads(tgrads, jgrads, trainable=GROUPS):
    ref = jax_to_state_dict(jgrads, {})
    assert set(ref) == set(tgrads)
    for name, g in ref.items():
        if group_of(name) not in trainable:
            assert not np.any(g), name  # JAX masks the frozen groups
            continue
        err = np.abs(tgrads[name] - g).max()
        assert err <= 1e-7 * np.abs(g).max() + 1e-12, (name, err)


def test_r3d_video_xprotonet_train_micro_step_matches_jax():
    cfg = {"name": "Video_XProtoNet", "base_architecture": "r3d_18",
           "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
           "num_classes": 4, "img_size": 32, "head_impl": "xla"}
    criterion = {"CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3,
                                   "ab_logitpath": "joined",
                                   "reduction": "mean"},
                 "ClusterRoiFeat": {"loss_weight": 0.8, "reduction": "mean"},
                 "Lnorm_occurrence": {"p": 2, "loss_weight": 0.001,
                                      "reduction": "mean"},
                 "trans_occurrence": {"loss_weight": 0.05,
                                      "reduction": "mean"}}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 32, 32, 3))
    y, v = np.array([0, 2], np.int32), np.array([True, True])
    tm = build_model(cfg, device="cpu")
    with jax.enable_x64(True):
        jm = jax_build_model(cfg, dtype=jnp.float64)
        params, stats = _trees(jm, tm, x.astype(np.float32), seed=3)
        params, stats = _f64(params), _f64(stats)
        key = jax.random.PRNGKey(7)
        loss_fn = make_xprotonet_loss_fn(
            jm, JaxBundle(criterion, num_classes=4, abstain_class=True),
            jnp.asarray(jm.class_identity()), combined=False)
        (total, aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
            key)
        jout = _np_tree({"loss_all": total, **aux["terms"]})
        jgrads = _np_tree(g)
        draw = tuple(float(a) for a in sample_affine_params(key))
    tm = tm.double()
    load_jax_variables(tm, params, stats)
    optimizer = GroupAdam(tm, weight_decay_by_group={g: 1e-3 for g in GROUPS})
    step, _, _ = make_xprotonet_steps(
        tm, LossBundle(criterion, num_classes=4, abstain_class=True),
        optimizer, GradAccumulator(optimizer.params, 2))
    tout = step(torch.from_numpy(x), torch.from_numpy(y).long(),
                torch.from_numpy(v), {g: 1e-4 for g in GROUPS}, affine=draw)
    assert not tout["applied"]
    _close_terms({k: t.numpy() for k, t in tout.items() if k != "applied"},
                 jout)
    _close_grads({k: p.grad.numpy() for k, p in tm.named_parameters()},
                 jgrads)


def test_vgg_ppnet_train_micro_step_matches_jax():
    cfg = dict(_ppnet_cfg("vgg11_bn"), add_on_layers_type="regular")
    criterion = {"CeLoss": {"loss_weight": 1, "reduction": "mean"},
                 "ClusterPatch": {"loss_weight": 0.8, "reduction": "mean"},
                 "SeparationPatch": {"loss_weight": 0.08,
                                     "reduction": "mean"},
                 "Lnorm_FC": {"p": 1, "loss_weight": 0.0001}}
    lrs = {"backbone": 1e-4, "add_on": 3e-3, "occurrence": 1e-4,
           "prototypes": 3e-3, "last_layer": 1e-4}
    wd = {"backbone": 1e-3, "add_on": 1e-3}
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, IMG, IMG, 3))
    y, v = np.array([0, 2], np.int32), np.array([True, True])
    tm = build_model(cfg, device="cpu")
    with jax.enable_x64(True):
        jm = jax_build_model(cfg, dtype=jnp.float64)
        params, stats = _trees(jm, tm, x.astype(np.float32), seed=5)
        params, stats = _f64(params), _f64(stats)
        tx = make_adam(weight_decay_by_group=wd, params=params)
        train_step, _, _ = jax_make_protopnet_steps(
            jm, JaxBundle(criterion, num_classes=K, abstain_class=False,
                          variant="protopnet"),
            tx, accumulation_steps=2, stage="joint", donate=False)
        state, m = train_step(TrainState.create(params, stats, tx),
                              jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                              jax.random.PRNGKey(0),
                              {g: jnp.float64(r) for g, r in lrs.items()})
        jout, jgrads = _np_tree(m), _np_tree(state.acc.acc)
    tm = tm.double()
    load_jax_variables(tm, params, stats)
    optimizer = GroupAdam(tm, weight_decay_by_group=wd)
    step, _, _ = make_protopnet_steps(
        tm, LossBundle(criterion, num_classes=K, abstain_class=False),
        optimizer, GradAccumulator(optimizer.params, 2), stage="joint")
    tout = step(torch.from_numpy(x), torch.from_numpy(y).long(),
                torch.from_numpy(v), lrs)
    assert not tout["applied"] and not bool(jout["applied"])
    _close_terms({k: t.numpy() for k, t in tout.items() if k != "applied"},
                 jout)
    _close_grads({k: p.grad.numpy() for k, p in tm.named_parameters()},
                 jgrads, STAGE_GROUPS["joint"])
