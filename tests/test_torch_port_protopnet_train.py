"""The port's ProtoPNet train step against the JAX package's at identical
weights, at each stage.

One accumulated Adam update (accumulation 2) of PPNet (ResNet-18, the
"regular" add-on, 64x64 images, P=6, D=32, K=3) with the loss of
``baseline_protopnet.yml`` (CE, ClusterPatch, SeparationPatch, L1(FC)),
at the stages warm, joint and last. The reference is the JAX package's
own ``make_protopnet_steps`` train step (its default "xla" head, whose
minimum splits a tie's cotangent evenly as the port's plain head does on
the CPU); its accumulator after the first micro-step holds that step's
masked gradients.

Both packages run in float64 (JAX in scoped 64-bit mode): in fp32 the two
frameworks' train-mode BatchNorm backward differs by up to ~2% of a
tensor's max gradient (``tests/test_torch_port_train.py``). Held:

- loss terms, logits and min distances: 1e-9 relative (plus 1e-12);
- gradients of the stage's trainable groups, per tensor: 1e-7 of max
  |g_jax|; the frozen groups' accumulated gradient is 0 in JAX;
- parameters after the update: 1e-10 absolute; the frozen groups bit for
  bit unchanged, with zero Adam moments;
- BN running statistics: 1e-9 relative (train mode updates them at every
  stage, also where the trunk is frozen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.losses.bundle import LossBundle as JaxBundle
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.train.optim import make_adam
from protoasnet_tpu.train.steps import TrainState
from protoasnet_tpu.train.steps import \
    make_protopnet_steps as jax_make_protopnet_steps
from protoasnet_tpu_torch.losses.bundle import LossBundle
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import (jax_to_state_dict,
                                                  load_jax_variables)
from protoasnet_tpu_torch.train.optim import (STAGE_GROUPS, GradAccumulator,
                                              GroupAdam, group_of)
from protoasnet_tpu_torch.train.steps import make_protopnet_steps

torch.set_num_threads(1)

P, D, K = 6, 32, 3
CFG = {"name": "ProtoPNet", "base_architecture": "resnet18",
       "prototype_shape": (P, D, 1, 1), "num_classes": K, "img_size": 64,
       "add_on_layers_type": "regular",
       "prototype_activation_function": "log", "head_impl": "xla"}
CRITERION = {"CeLoss": {"loss_weight": 1, "reduction": "mean"},
             "ClusterPatch": {"loss_weight": 0.8, "reduction": "mean"},
             "SeparationPatch": {"loss_weight": 0.08, "reduction": "mean"},
             "Lnorm_FC": {"p": 1, "loss_weight": 0.0001}}
WD = {"backbone": 1e-3, "add_on": 1e-3}  # the staged agent's
LRS = {"backbone": 1e-4, "add_on": 3e-3, "occurrence": 1e-4,
       "prototypes": 3e-3, "last_layer": 1e-4}
TOL_GRAD = 1e-7


def _random_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(scale=0.2, size=v.shape)
        else:
            out[k] = rng.uniform(0.5, 2.0, size=v.shape)
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _run(stage):
    """Two micro-steps and the update at ``stage``, in both packages."""
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=(2, 64, 64, 3)) for _ in range(2)]
    ys = [np.array([0, 2], np.int32), np.array([1, 0], np.int32)]
    vs = [np.array([True, True]), np.array([True, False])]

    with jax.enable_x64(True):
        jm = jax_build_model(CFG, dtype=jnp.float64)
        params, stats = init_model(jm, jnp.asarray(xs[0][:1]), seed=0)
        params = _f64(_np_tree(params))
        stats = _f64(_random_stats(jax.device_get(stats), rng))
        tx = make_adam(weight_decay_by_group=WD, params=params)
        train_step, _, _ = jax_make_protopnet_steps(
            jm, JaxBundle(CRITERION, num_classes=K, abstain_class=False,
                          variant="protopnet"),
            tx, accumulation_steps=2, stage=stage, donate=False)
        state = TrainState.create(params, stats, tx)
        lrs = {g: jnp.float64(v) for g, v in LRS.items()}
        jout = []
        for i, (x, y, v) in enumerate(zip(xs, ys, vs)):
            state, m = train_step(state, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(v), jax.random.PRNGKey(0), lrs)
            jout.append(_np_tree(m))
            if i == 0:
                jgrads = _np_tree(state.acc.acc)
        assert bool(jout[1]["applied"])
        jparams, jstats = _np_tree(state.params), _np_tree(state.batch_stats)

    tm = build_model(CFG, device="cpu").double()
    load_jax_variables(tm, params, stats)
    optimizer = GroupAdam(tm, weight_decay_by_group=WD)
    step, _, _ = make_protopnet_steps(
        tm, LossBundle(CRITERION, num_classes=K, abstain_class=False),
        optimizer, GradAccumulator(optimizer.params, 2), stage=stage)
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    tout, tgrad1 = [], None
    for x, y, v in zip(xs, ys, vs):
        tout.append(step(torch.from_numpy(x), torch.from_numpy(y).long(),
                         torch.from_numpy(v), LRS))
        if tgrad1 is None:  # the first micro-step's gradient, still in .grad
            tgrad1 = {k: p.grad.clone() for k, p in tm.named_parameters()}
    return dict(jout=jout, tout=tout, jgrads=jgrads, tgrad1=tgrad1,
                jparams=jparams, jstats=jstats, tm=tm, before=before,
                optimizer=optimizer)


@pytest.fixture(scope="module", params=["warm", "joint", "last"])
def run(request):
    return request.param, _run(request.param)


def _close(port, ref, name, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=name)


def test_loss_terms_logits_and_min_distances(run):
    _, r = run
    for micro in (0, 1):
        j, t = r["jout"][micro], r["tout"][micro]
        assert t["applied"] == (micro == 1) == bool(j["applied"])
        assert set(t) == set(j)
        for name in j:
            if name == "applied":
                continue
            if name.startswith("loss"):
                assert float(j[name]) != 0.0, name  # every term is on
            _close(t[name].numpy(), j[name], f"{name} micro {micro}")


def test_gradients_of_the_trainable_groups(run):
    stage, r = run
    ref = jax_to_state_dict(r["jgrads"], {})
    got = r["tgrad1"]
    assert set(ref) == set(got)
    trainable = set(STAGE_GROUPS[stage])
    for name, g in ref.items():
        if group_of(name) not in trainable:
            assert not np.any(g), name  # JAX masks the frozen groups
            continue
        scale = np.abs(g).max()
        err = np.abs(got[name].numpy() - g).max()
        assert err <= TOL_GRAD * scale + 1e-12, (name, err, scale)


def test_parameters_after_the_update(run):
    stage, r = run
    ref_new = jax_to_state_dict(r["jparams"], {})
    trainable = set(STAGE_GROUPS[stage])
    state = r["optimizer"].optimizer.state
    for name, p in r["tm"].named_parameters():
        if group_of(name) in trainable:
            moved = p.detach() - r["before"][name]
            assert moved.abs().max() > 0.5 * LRS[group_of(name)], name
        else:
            assert torch.equal(p, r["before"][name]), name
            assert not state[p]["exp_avg"].any(), name
            assert not state[p]["exp_avg_sq"].any(), name
        np.testing.assert_allclose(p.detach().numpy(), ref_new[name],
                                   rtol=0, atol=1e-10, err_msg=name)


def test_bn_running_stats(run):
    _, r = run
    ref = jax_to_state_dict({}, r["jstats"])
    sd = r["tm"].state_dict()
    for name, val in ref.items():
        _close(sd[name].numpy(), val, name)
