"""``model.remat`` in the port: the video trunk's blocks checkpointed in
training, against the port without it and the JAX package with it.

The float64 accumulated train step of ``tests/test_torch_port_train.py``
(video XProtoNet, 8 frames of 32x32, P=8, D=64, K=4, all seven loss
terms, accumulation 2, the TransformLoss forward of affine(x) in train
mode under ``own_bn_stats``):

- with ``remat: true`` the port gives the gradients, the weights after
  the Adam step, and every BatchNorm running statistic and
  ``num_batches_tracked`` of the port without it, to 1e-12 of each
  tensor's max;
- it matches the JAX package's step with ``remat: true`` (``nn.remat``
  around each block), to 1e-7 of each gradient tensor's max, as the
  un-rematted step is held;
- a naive checkpoint (the recompute not under ``own_bn_stats``) updates
  the statistics again during ``backward()``, for the main and for the
  affine forward, so the comparison fails on it: the test that shows the
  double update;
- eval-mode and no-grad forwards never checkpoint and give bit-equal
  outputs (serving and push are unchanged).
"""

import contextlib

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
from protoasnet_tpu_torch.models.backbones import r2plus1d
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import (jax_to_state_dict,
                                                  load_jax_variables)
from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                              GroupAdam)
from protoasnet_tpu_torch.train.steps import make_xprotonet_steps
from tests.test_torch_port_train import (CFG, CRITERION, LR, TOL_GRAD, WD,
                                         _f64, _np_tree, _random_stats)
from torch_port_isolation import isolated

_isolated = isolated(1)

K = CFG["num_classes"]
TOL_SAME = 1e-12


def _data():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 8, 32, 32, 3)) for _ in range(2)]
    ys = [np.array([0, 2], np.int32), np.array([1, 0], np.int32)]
    vs = [np.array([True, True]), np.array([True, False])]
    return rng, xs, ys, vs


@pytest.fixture(scope="module")
def jax_remat():
    """The JAX package's two micro-steps and update with ``remat: true``,
    in float64: the weights it starts from, the affine draws, the first
    gradient, the weights after the update and the BN statistics."""
    rng, xs, ys, vs = _data()
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.PRNGKey(7), 2)
        jm = jax_build_model(dict(CFG, remat=True), dtype=jnp.float64)
        assert jm.remat
        params, stats = init_model(jm, jnp.asarray(xs[0][:1]), seed=0)
        params = _f64(_np_tree(params))
        stats = _f64(_random_stats(jax.device_get(stats), rng))
        kernel = params["last_layer"]["Dense_0"]["kernel"]
        params["last_layer"]["Dense_0"]["kernel"] = \
            kernel + rng.normal(scale=0.05, size=kernel.shape)
        loss_fn = make_xprotonet_loss_fn(
            jm, JaxBundle(CRITERION, num_classes=K, abstain_class=True),
            jnp.asarray(jm.class_identity()), combined=False)
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        tx = make_adam(weight_decay_by_group={g: WD for g in GROUPS},
                       params=params)
        opt, acc = tx.init(params), JaxAcc.init(params)
        jstats, grads, draws = stats, [], []
        for x, y, v, key in zip(xs, ys, vs, keys):
            (_, aux), g = grad_fn(params, jstats, jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(v), key)
            jstats = aux["batch_stats"]
            grads.append(_np_tree(g))
            draws.append(tuple(float(a) for a in jax_affine_draw(key)))
            upd, acc, opt, applied = accumulate_and_maybe_update(
                tx, g, acc, opt, params, 2)
        assert bool(applied)
        new = _np_tree(jax.tree_util.tree_map(lambda p, u: p - LR * u,
                                              params, upd))
    return dict(params=params, stats=stats, draws=draws, grad=grads[0],
                new=new, new_stats=_np_tree(jstats))


def _port_step(jr, remat: bool):
    """The port's two micro-steps and update from the JAX run's weights:
    (first gradient, parameters, state_dict after the update)."""
    _, xs, ys, vs = _data()
    tm = build_model(dict(CFG, remat=remat), device="cpu").double()
    assert tm.cnn_backbone.remat == remat
    load_jax_variables(tm, jr["params"], jr["stats"])
    optimizer = GroupAdam(tm, weight_decay_by_group={g: WD for g in GROUPS})
    train_step, _, _ = make_xprotonet_steps(
        tm, LossBundle(CRITERION, num_classes=K, abstain_class=True),
        optimizer, GradAccumulator(optimizer.params, 2))
    grad = None
    for x, y, v, aff in zip(xs, ys, vs, jr["draws"]):
        train_step(torch.from_numpy(x), torch.from_numpy(y).long(),
                   torch.from_numpy(v), {g: LR for g in GROUPS}, affine=aff)
        if grad is None:
            grad = {k: p.grad.clone() for k, p in tm.named_parameters()}
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    return grad, params, {k: v.clone() for k, v in tm.state_dict().items()}


@pytest.fixture(scope="module")
def port(jax_remat):
    return {remat: _port_step(jax_remat, remat) for remat in (False, True)}


def _assert_same(got, ref, what, tol=TOL_SAME):
    assert set(got) == set(ref), what
    for name, r in ref.items():
        g = got[name]
        if not r.is_floating_point():  # num_batches_tracked
            assert torch.equal(g, r), (what, name, g, r)
            continue
        err = (g - r).abs().max().item()
        assert err <= tol * r.abs().max().item() + 1e-300, \
            (what, name, err)


@pytest.mark.parametrize("part", ["gradients", "weights", "bn_statistics"])
def test_remat_step_equals_the_plain_step(port, part):
    i = {"gradients": 0, "weights": 1, "bn_statistics": 2}[part]
    got, ref = port[True][i], port[False][i]
    if part == "bn_statistics":
        ref = {k: v for k, v in ref.items()
               if k.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))}
        got = {k: got[k] for k in ref}
        # one update per micro-step's main forward: 2 for every BN
        assert {int(v) for k, v in ref.items()
                if k.endswith("num_batches_tracked")} == {2}
    _assert_same(got, ref, part)


def test_remat_step_matches_the_jax_remat_step(port, jax_remat):
    grad, params, sd = port[True]
    ref = jax_to_state_dict(jax_remat["grad"], {})
    assert set(ref) == set(grad)
    for name, g in ref.items():
        err = np.abs(grad[name].numpy() - g).max()
        assert err <= TOL_GRAD * np.abs(g).max() + 1e-12, (name, err)
    for name, val in jax_to_state_dict(jax_remat["new"], {}).items():
        np.testing.assert_allclose(params[name].numpy(), val, rtol=0,
                                   atol=1e-10, err_msg=name)
    for name, val in jax_to_state_dict({}, jax_remat["new_stats"]).items():
        np.testing.assert_allclose(sd[name].numpy(), val, rtol=1e-9,
                                   atol=1e-12, err_msg=name)


def test_a_naive_checkpoint_updates_the_statistics_twice(jax_remat,
                                                         port, monkeypatch):
    """Without ``own_bn_stats`` around the recompute, ``backward()`` runs
    each block's train-mode BatchNorm again, for the main forward and for
    the affine(x) forward, whose ``own_bn_stats`` has exited by then: a
    block's ``num_batches_tracked`` goes to 6 instead of 2 over the two
    micro-steps, and the running statistics take the affine batches'
    statistics too, so the comparison above fails on it."""
    monkeypatch.setattr(r2plus1d, "own_bn_stats",
                        lambda module: contextlib.nullcontext())
    _, _, naive = _port_step(jax_remat, remat=True)
    plain = port[False][2]
    block = "cnn_backbone.layer1_0.bn1."
    assert int(naive[block + "num_batches_tracked"]) == 6
    assert int(plain[block + "num_batches_tracked"]) == 2
    assert int(naive["cnn_backbone.stem_bn1.num_batches_tracked"]) == 2
    with pytest.raises(AssertionError):
        _assert_same({k: naive[k] for k in plain}, plain, "naive")


@pytest.mark.parametrize("mode", ["eval", "no_grad"])
def test_remat_changes_nothing_without_a_train_graph(mode, monkeypatch):
    """Serving (eval) and push (no grad) never checkpoint: the outputs are
    bit-equal to the model without remat, and the state_dict keys are the
    same."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 8, 32, 32, 3)).astype(np.float32))
    plain = build_model(CFG, device="cpu", seed=4)
    remat = build_model(dict(CFG, remat=True), device="cpu", seed=4)
    assert list(plain.state_dict()) == list(remat.state_dict())

    def refuse(*a, **k):
        raise AssertionError("checkpointed outside a train-mode graph")

    monkeypatch.setattr(r2plus1d, "checkpoint", refuse)
    outs = []
    for m in (plain, remat):
        if mode == "eval":
            m.eval()
            with torch.no_grad():
                outs.append(m(x))
        else:
            m.train()
            with torch.no_grad():
                outs.append(m(x))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
