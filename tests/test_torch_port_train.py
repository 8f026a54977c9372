"""The port's train step against the JAX package's at identical weights.

One accumulated Adam update (accumulation 2) of the video XProtoNet at a
small size (8 frames of 32x32, P=8, D=64, K=4). The JAX reference is
``make_xprotonet_loss_fn(combined=False)`` (x and affine(x) in separate
train-mode passes, the second pass's running stats dropped) with
``accumulate_and_maybe_update`` and ``make_adam``; the affine draws are
JAX's, passed to the port. All seven loss terms are on, so each one's
gradient is in the comparison.

Both packages run in float64 here (JAX in scoped 64-bit mode). In fp32
the trunk's gradients of the two frameworks differ by up to ~2% of a
tensor's largest entry (measured on this fixture: the stem kernel 1.4e-2,
layer3_1's spatial conv 2.9e-1 of a small max |g| of 6e-3; the head's
gradients within 3e-5): train-mode BatchNorm's backward at batch 2 is a
small difference of large sums, and torch's closed-form BN backward and
JAX's autodiff of mean/var round it differently through 17 BN layers.
That is the same kind of drift as the eval-mode stem-gradient gap of
``tests/test_grad_parity_torch.py`` (1.3e-5 on values near 1e-4), only
larger; no fp32 tolerance would separate it from a real fault. In float64
that noise falls below 1e-9 and the comparison is tight:

- loss terms, logits, similarities and new BN running stats: 1e-9
  relative (plus 1e-12 absolute);
- gradients, per parameter tensor: 1e-7 of max |g_jax|;
- parameters after the update: 1e-10 absolute (Adam's first step moves
  each element by lr * sign(g); no sign flips at these gradient errors).

The fp32 step itself is held on the card against the port's CPU fp32 step
(``chip_smoke.py`` phase 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.losses.bundle import LossBundle as JaxBundle
from protoasnet_tpu.losses.losses import (
    sample_affine_params as jax_affine_draw)
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.train.optim import (GradAccumulator as JaxAcc,
                                        accumulate_and_maybe_update,
                                        make_adam)
from protoasnet_tpu.train.steps import make_xprotonet_loss_fn
from protoasnet_tpu_torch.losses.bundle import LossBundle
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import (jax_to_state_dict,
                                                  load_jax_variables)
from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                              GroupAdam, ReduceLROnPlateau,
                                              StepLR, group_of)
from protoasnet_tpu_torch.train.steps import make_xprotonet_steps
from torch_port_isolation import isolated

_isolated = isolated(1)

P, D, K = 8, 64, 4
CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (P, D, 1, 1, 1),
       "num_classes": K, "img_size": 32, "head_impl": "xla"}
# every term on (the flagship's weights, and the two it leaves at 0)
CRITERION = {
    "CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3,
                      "ab_logitpath": "joined", "reduction": "mean"},
    "ClusterRoiFeat": {"loss_weight": 0.8, "reduction": "mean"},
    "SeparationRoiFeat": {"loss_weight": 0.08, "reduction": "mean"},
    "OrthogonalityLoss": {"loss_weight": 0.01, "mode": "per_class"},
    "Lnorm_occurrence": {"p": 2, "loss_weight": 0.001, "reduction": "mean"},
    "trans_occurrence": {"loss_weight": 0.05, "reduction": "mean"},
    "Lnorm_FC": {"p": 1, "loss_weight": 0.0001},
}
LR, WD = 1e-4, 1e-3
TOL_GRAD = 1e-7


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def run():
    """Two micro-steps and the update, in both packages, in float64."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 8, 32, 32, 3)) for _ in range(2)]
    ys = [np.array([0, 2], np.int32), np.array([1, 0], np.int32)]
    vs = [np.array([True, True]), np.array([True, False])]

    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.PRNGKey(7), 2)
        jm = jax_build_model(CFG, dtype=jnp.float64)
        params, stats = init_model(jm, jnp.asarray(xs[0][:1]), seed=0)
        params = _f64(_np_tree(params))
        stats = _f64(_random_stats(jax.device_get(stats), rng))
        # off-class readout weights (0 at init) so that L1(FC) is not 0
        kernel = params["last_layer"]["Dense_0"]["kernel"]
        params["last_layer"]["Dense_0"]["kernel"] = \
            kernel + rng.normal(scale=0.05, size=kernel.shape)

        class_identity = jnp.asarray(jm.class_identity())
        jbundle = JaxBundle(CRITERION, num_classes=K, abstain_class=True)
        loss_fn = make_xprotonet_loss_fn(jm, jbundle, class_identity,
                                         combined=False)
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        tx = make_adam(weight_decay_by_group={g: WD for g in GROUPS},
                       params=params)
        opt, acc = tx.init(params), JaxAcc.init(params)
        jstats, jout, jgrads, draws = stats, [], [], []
        for x, y, v, key in zip(xs, ys, vs, keys):
            (total, aux), g = grad_fn(params, jstats, jnp.asarray(x),
                                      jnp.asarray(y), jnp.asarray(v), key)
            jstats = aux["batch_stats"]
            jout.append(_np_tree({"loss_all": total, **aux["terms"],
                                  "logits": aux["logits"],
                                  "similarities": aux["similarities"]}))
            jgrads.append(_np_tree(g))
            draws.append(tuple(float(a) for a in jax_affine_draw(key)))
            upd, acc, opt, applied = accumulate_and_maybe_update(
                tx, g, acc, opt, params, 2)
        assert bool(applied)
        jparams = _np_tree(jax.tree_util.tree_map(
            lambda p, u: p - LR * u, params, upd))
        jstats = _np_tree(jstats)

    tm = build_model(CFG, device="cpu").double()
    load_jax_variables(tm, params, stats)
    optimizer = GroupAdam(tm, weight_decay_by_group={g: WD for g in GROUPS})
    accum = GradAccumulator(optimizer.params, 2)
    train_step, _, _ = make_xprotonet_steps(
        tm, LossBundle(CRITERION, num_classes=K, abstain_class=True),
        optimizer, accum)
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    tout, tgrad1 = [], None
    for x, y, v, aff in zip(xs, ys, vs, draws):
        tout.append(train_step(torch.from_numpy(x),
                               torch.from_numpy(y).long(),
                               torch.from_numpy(v), {g: LR for g in GROUPS},
                               affine=aff))
        if tgrad1 is None:  # the first micro-step's gradient, still in .grad
            tgrad1 = {k: p.grad.clone() for k, p in tm.named_parameters()}
    return dict(jout=jout, tout=tout, jgrads=jgrads, tgrad1=tgrad1,
                params=params, jparams=jparams, jstats=jstats, tm=tm,
                before=before)


def _close(port, ref, name, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("micro", [0, 1])
def test_loss_terms_logits_and_similarities(run, micro):
    j, t = run["jout"][micro], run["tout"][micro]
    assert set(t) - {"applied"} == set(j)
    assert t["applied"] == (micro == 1)
    for name in j:
        if name.startswith("loss"):
            assert float(j[name]) != 0.0, name  # every term is on
        _close(t[name].numpy(), j[name], name)


def _grad_table(grads):
    return jax_to_state_dict(grads, {})


def test_gradients_per_parameter(run):
    ref = _grad_table(run["jgrads"][0])
    got = run["tgrad1"]
    assert set(ref) == set(got)
    for name, g in ref.items():
        scale = np.abs(g).max()
        err = np.abs(got[name].numpy() - g).max()
        assert err <= TOL_GRAD * scale + 1e-12, (name, err, scale)


def test_bn_running_stats_after_two_micro_steps(run):
    """Only the main passes' statistics reach the running stats; the
    affine(x) passes' updates are dropped."""
    ref = jax_to_state_dict({}, run["jstats"])
    sd = run["tm"].state_dict()
    for name, val in ref.items():
        _close(sd[name].numpy(), val, name)


def test_parameters_after_the_accumulated_update(run):
    ref_new = jax_to_state_dict(run["jparams"], {})
    for name, p in run["tm"].named_parameters():
        moved = p.detach() - run["before"][name]
        assert moved.abs().max() > 0.5 * LR, name  # every group stepped
        np.testing.assert_allclose(p.detach().numpy(), ref_new[name],
                                   rtol=0, atol=1e-10, err_msg=name)


def test_frozen_stage_keeps_groups_bit_identical():
    """Stage "warm": the trunk and the readout get no update and keep zero
    Adam moments; the other groups step."""
    tm = build_model(CFG, device="cpu", seed=3)
    optimizer = GroupAdam(tm, weight_decay_by_group={g: WD for g in GROUPS})
    accum = GradAccumulator(optimizer.params, 1)
    train_step, _, _ = make_xprotonet_steps(
        tm, LossBundle(CRITERION, num_classes=K, abstain_class=True),
        optimizer, accum, stage="warm")
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    rng = np.random.default_rng(1)
    for _ in range(2):
        x = torch.from_numpy(rng.normal(size=(2, 8, 32, 32, 3)
                                        ).astype(np.float32))
        m = train_step(x, torch.tensor([0, 1]), torch.tensor([True, True]),
                       {g: 1e-3 for g in GROUPS}, affine=(5.0, 1.1))
        assert m["applied"]
    state = optimizer.optimizer.state
    for name, p in tm.named_parameters():
        frozen = group_of(name) in ("backbone", "last_layer")
        if frozen:
            assert torch.equal(p, before[name]), name
            assert not state[p]["exp_avg"].any(), name
            assert not state[p]["exp_avg_sq"].any(), name
        else:
            assert not torch.equal(p, before[name]), name
        assert float(state[p]["step"]) == 2.0  # one step count for all


def test_schedulers_follow_torch_semantics():
    s = ReduceLROnPlateau(1.0, mode="max", factor=0.5, patience=1,
                          cooldown=1, min_lr=0.3)
    seen = [s.step(m) for m in (0.5, 0.4, 0.4, 0.4, 0.4, 0.4, 0.9)]
    assert seen == [1.0, 1.0, 0.5, 0.5, 0.5, 0.3, 0.3]
    st = StepLR(1.0, step_size=2, gamma=0.1)
    assert [round(st.step(), 6) for _ in range(4)] == [1.0, 0.1, 0.1, 0.01]
    s2 = ReduceLROnPlateau(1.0)
    s2.load_state_dict(s.state_dict())
    assert s2.state_dict() == s.state_dict()
