"""The port's prototype tensor parallelism (``parallel/mesh.py``:
``make_mesh_2d``, ``prototype_param_shardings`` and the split heads) on
CPU ranks against one process and the JAX package.

Six processes spawned with ``torch.multiprocessing`` join two gloo groups
through ``FileStore``s and run ``tests/torch_tp_driver.py``'s scenarios:
four as a 2 x 2 (data, model) mesh on the tiny flagship (8 frames of
32x32, P=8, D=64, K=4: two prototypes of two classes on each model rank),
two as a 1 x 2 mesh on an image XProtoNet and a ProtoPNet with P=6, K=3
(three prototypes a rank, two a class: class 1 straddles the ranks). This
process runs the same scenarios without a group (the single-process port)
and the JAX package's own train step on one device. The weights are the
JAX package's initial ones (the flagship's readout moved off its 0s),
loaded onto the shards. Held:

- every rank's step-1 loss within rtol 2e-5 of the single-process port's
  and of the JAX package's step on the same global batch; the logits of
  the rank's rows and the whole similarities (distances) of one process;
- in float64, the accumulator's saved gradient (summed over ``data``,
  gathered over ``model``) within 1e-10 of each tensor's max |g| of one
  process's, the BN running statistics within 1e-12, the parameters after
  an update within 1e-10, the same whole state on every rank (the data
  replicas of each shard bit-identical); Adam's state saved as whole
  tensors equal to one process's, loaded onto fresh shards (each rank its
  block) and saved again bit for bit;
- both pushes: the winners, their classes and similarities (distances)
  and the new prototype vectors of one process;
- the JAX weights loaded onto the shards bit-equal to the full weights
  placed by ``prototype_param_shardings``;
- ``prototype_placements`` against the JAX package's
  ``prototype_param_shardings`` leaf by leaf, the layouts transposed;
  ``make_mesh_2d`` raising where the JAX one does and where its groups
  cannot be formed, never falling back to a 1-D mesh.

The JAX package's own 2-D GSPMD step (``tests/test_train_step.py``) stays
slow-marked; nothing here compiles it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_driver as dp
import torch_tp_driver as tp
from protoasnet_tpu.losses.bundle import LossBundle as JaxBundle
from protoasnet_tpu.losses.losses import \
    sample_affine_params as jax_affine_draw
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from protoasnet_tpu.parallel.mesh import \
    prototype_param_shardings as jax_prototype_shardings
from protoasnet_tpu.train.optim import GROUPS, make_adam
from protoasnet_tpu.train.steps import (TrainState, make_protopnet_steps,
                                        make_xprotonet_steps)
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import jax_to_state_dict
from protoasnet_tpu_torch.parallel import mesh
from torch_port_isolation import isolated, removed_after

_isolated = isolated(1)

JOIN_S = 600  # a rank that hangs fails the test, far inside the run's limit
GROUPS_OF_RANKS = {"flagship": (4, ("flagship",)),
                   "image": (2, ("image", "ppnet"))}


def _jax_vars(cfg, x, perturb_readout=False):
    params, stats = jax.device_get(init_model(
        jax_build_model(cfg), jnp.asarray(x[:1]), seed=0))
    if perturb_readout:  # off-class readout weights (0 at init): L1(FC) > 0
        kernel = params["last_layer"]["Dense_0"]["kernel"]
        params["last_layer"]["Dense_0"]["kernel"] = kernel + \
            np.random.default_rng(11).normal(
                scale=0.05, size=kernel.shape).astype(np.float32)
    return params, stats


def _jax_loss(cfg, criterion, k, jax_vars, batch, protopnet=False):
    """The JAX package's one-device step-1 loss on the global batch."""
    model = jax_build_model(cfg)
    params, stats = jax_vars
    tx = make_adam(weight_decay_by_group={g: dp.WD for g in GROUPS},
                   params=params)
    if protopnet:
        step, _, _ = make_protopnet_steps(
            model, JaxBundle(criterion, num_classes=k, abstain_class=False,
                             variant="protopnet"), tx, accumulation_steps=1,
            stage="all", donate=False)
    else:
        step, _, _ = make_xprotonet_steps(
            model, JaxBundle(criterion, num_classes=k, abstain_class=True),
            tx, accumulation_steps=1, stage="all", donate=False)
    x, y, v = (jnp.asarray(a) for a in batch)
    _, m = step(TrainState.create(params, stats, tx), x, y, v,
                jax.random.PRNGKey(0),
                {g: jnp.float32(dp.LR) for g in GROUPS})
    return float(m["loss_all"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results beside this process's references."""
    from protoasnet_tpu_torch.data.dataset import get_as_dataloader
    from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset

    tmp = tmp_path_factory.mktemp("tensor_parallel")
    with removed_after(tmp):
        csv = make_synthetic_dataset(str(tmp / "data"), num_videos=12,
                                     seed=3)
        get_as_dataloader({"data_info_file": csv, "batch_size": 4,
                           "frames": 8, "img_size": 32}, "train", "val",
                          device="cpu")  # the packed store, once
        video, image = dp.padded_global_batch(), dp.image_batch()
        jax_vars = {"flagship": _jax_vars(dp.CFG, video[0], True),
                    "image": _jax_vars(tp.IMAGE, image[0]),
                    "ppnet": _jax_vars(tp.PPNET, image[0])}
        draw = tuple(float(a) for a in jax_affine_draw(jax.random.PRNGKey(0)))
        inputs = {"jax": jax_vars, "draw": draw, "csv": csv}
        torch.save(inputs, tmp / "inputs.pt")

        ctx = mp.get_context("spawn")
        procs = []
        for key, (world, names) in GROUPS_OF_RANKS.items():
            out = tmp / key
            out.mkdir()
            procs += [ctx.Process(target=tp.run_rank, args=(
                r, world, str(tmp / f"store_{key}"), str(out), names,
                str(tmp / "inputs.pt"))) for r in range(world)]
        for p in procs:
            p.start()
        try:
            one = {name: tp.scenario(name, dict(
                inputs, push_root=str(tmp / "push_one")))
                for name in ("flagship", "image", "ppnet")}
            jax_loss = {
                "flagship": _jax_loss(dp.CFG, dp.CRITERION, dp.K,
                                      jax_vars["flagship"], video),
                "image": _jax_loss(tp.IMAGE, dp.CRITERION, 3,
                                   jax_vars["image"], tp.image_batch()),
                "ppnet": _jax_loss(tp.PPNET, dp.PPNET_CRITERION, 3,
                                   jax_vars["ppnet"], image,
                                   protopnet=True)}
            for p in procs:
                p.join(JOIN_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
        assert [p.exitcode for p in procs] == [0] * len(procs), \
            f"rank exit codes {[p.exitcode for p in procs]}"
        ranks = {key: [torch.load(tmp / key / f"rank{r}.pt",
                                  weights_only=False) for r in range(world)]
                 for key, (world, _) in GROUPS_OF_RANKS.items()}
        yield {"one": one, "jax": jax_loss, "tmp": tmp,
               "flagship": ranks["flagship"], "image": ranks["image"],
               "ppnet": ranks["image"]}


def _ranks(runs, name):
    return [r[name] for r in runs[name]]


def _close(got, ref, tol, what):
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= tol * scale + 1e-300, (what, err, scale)


# ---------------- the mesh and the placement rule ----------------


def test_ranks_lie_row_major_on_the_mesh(runs):
    assert [r["mesh"] for r in runs["flagship"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["mesh"] for r in runs["image"]] == [(0, 0), (0, 1)]


@pytest.mark.parametrize("cfg", [dp.CFG, tp.IMAGE, tp.PPNET],
                         ids=["flagship", "image", "ppnet"])
def test_placement_rule_is_the_jax_rule(cfg):
    """Leaf by leaf: the port's dim over ``model`` is the JAX one moved to
    the torch layout (a Dense kernel (I, O) is a Linear weight (O, I))."""
    x = np.zeros((1, 8, 32, 32, 3) if cfg is dp.CFG else (1, 64, 64, 3),
                 np.float32)
    params, _ = jax.device_get(init_model(jax_build_model(cfg),
                                          jnp.asarray(x), seed=0))
    shardings = jax_prototype_shardings(
        params, jax_make_mesh_2d(2, 2, jax.devices()[:4]))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = jax.tree_util.tree_leaves(shardings)
    want = {}
    for (path, leaf), s in zip(leaves, specs):
        keys = [p.key for p in path]
        spec = tuple(s.spec)
        dim = spec.index("model") if "model" in spec else None
        if dim is not None and keys[-1] == "kernel":
            dim = 1 - dim  # (I, O) -> (O, I)
        (name,) = jax_to_state_dict(_nest(keys, leaf), {})
        want[name] = dim
    ours = mesh.prototype_placements(build_model(cfg, device="cpu"))
    assert ours == want
    assert sum(d is not None for d in ours.values()) == \
        (2 if cfg is tp.PPNET else 3)


def _nest(keys, leaf):
    tree = leaf
    for k in reversed(keys):
        tree = {k: tree}
    return tree


def test_prototypes_must_split_evenly():
    model = build_model(tp.IMAGE, device="cpu")  # P=6
    with pytest.raises(ValueError, match="equal blocks"):
        mesh.prototype_param_shardings(model, mesh.Mesh2D(1, 4, None, None,
                                                          None))


def test_make_mesh_2d_raises_where_jax_does(monkeypatch):
    monkeypatch.setattr(mesh, "_MESH", None)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        jax_make_mesh_2d(2, 2, jax.devices()[:2])
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        mesh.make_mesh_2d(2, 2)
    one = mesh.make_mesh_2d(1, 1)  # a one-process run: a 1 x 1 mesh
    assert (one.n_data, one.n_model) == (1, 1) and mesh.data_size() == 1


def test_make_mesh_2d_never_falls_back(monkeypatch):
    """Groups that cannot be formed raise; no 1-D mesh takes over."""
    monkeypatch.setattr(mesh, "world_size", lambda: 4)

    def boom(*a, **k):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "new_subgroups_by_enumeration",
                        boom)
    monkeypatch.setattr(mesh, "_MESH", None)
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        mesh.make_mesh_2d(2, 2)
    assert mesh._MESH is None
    with pytest.raises(ValueError, match="each rank must be one cell"):
        mesh.make_mesh_2d(1, 2)


# ---------------- the train step ----------------


@pytest.mark.parametrize("name", ["flagship", "image", "ppnet"])
def test_step_loss_matches_one_process_and_jax(runs, name):
    """The loss on every rank; the logits and the whole similarities
    (distances) of the rank's rows, each data rank a block."""
    one, ref = runs["one"][name], runs["jax"][name]
    meshes = [x["mesh"] for x in runs["image" if name == "ppnet" else name]]
    for (d, _), r in zip(meshes, _ranks(runs, name)):
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=2e-5)
        np.testing.assert_allclose(r["loss"], ref, rtol=2e-5)
        n = r["logits"].shape[0]
        for k in ("logits", "whole"):
            assert r[k].shape[1:] == one[k].shape[1:], k
            np.testing.assert_allclose(
                r[k].numpy(), one[k][d * n:(d + 1) * n].numpy(), rtol=1e-4,
                atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["flagship", "image", "ppnet"])
def test_float64_gradients_match_one_process(runs, name):
    """The accumulator's saved partial sum: summed over ``data``, gathered
    over ``model``, the whole global batch's gradient."""
    one = runs["one"][name]["saved"]
    for r in _ranks(runs, name):
        got = r["saved"]
        assert got["count"] == one["count"] == 1
        assert len(got["grads"]) == len(one["grads"])
        for i, (a, g) in enumerate(zip(got["grads"], one["grads"])):
            assert a.shape == g.shape, i
            _close(a, g, 1e-10, i)


@pytest.mark.parametrize("name", ["flagship", "image", "ppnet"])
def test_float64_state_matches_one_process(runs, name):
    one = runs["one"][name]
    names = [k for k in one["state"] if "running_" in k]
    assert names
    for r in _ranks(runs, name):
        np.testing.assert_allclose(r["loss64"], one["loss64"], rtol=1e-12)
        for k in names:
            np.testing.assert_allclose(r["state"][k].numpy(),
                                       one["state"][k].numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=k)
        moved = 0
        for k, v in one["after"].items():
            _close(r["after"][k], v, 1e-10, k)
            moved += not torch.equal(v, one["state"][k]) and \
                "running_" not in k
        assert moved > 0
    first = _ranks(runs, name)[0]["after"]
    for r in _ranks(runs, name)[1:]:  # one whole state on every rank
        for k, v in first.items():
            assert torch.equal(r["after"][k], v), k


@pytest.mark.parametrize("name", ["flagship", "image", "ppnet"])
def test_adam_state_saves_whole_and_loads_onto_shards(runs, name):
    one = runs["one"][name]["adam"]
    for r in _ranks(runs, name):
        assert set(r["adam"]) == set(one)
        for i, s in one.items():
            for k in ("exp_avg", "exp_avg_sq"):
                got = r["adam"][i][k]
                assert type(got) is torch.Tensor and got.shape == s[k].shape
                _close(got, s[k], 1e-10, (i, k))
                assert torch.equal(r["reloaded"][i][k], got), (i, k)
    meshes = [x["mesh"] for x in runs["image" if name == "ppnet" else name]]
    for (_, m), r in zip(meshes, _ranks(runs, name)):
        for i, local in r["local_moments"].items():
            full = r["adam"][i]["exp_avg"]
            if local.shape != full.shape:  # this rank's block of the whole
                dim = [a != b for a, b in zip(local.shape,
                                              full.shape)].index(True)
                full = full.narrow(dim, m * local.shape[dim],
                                   local.shape[dim])
            assert torch.equal(local, full), i


# ---------------- push, weights ----------------


def test_flagship_push_equals_one_process(runs):
    one = runs["one"]["flagship"]["push"]
    for r in _ranks(runs, "flagship"):
        got = r["push"]
        for k in ("prototypes_filenames", "prototypes_gts"):
            np.testing.assert_array_equal(got["info"][k], one["info"][k])
        np.testing.assert_allclose(
            got["info"]["prototypes_similarity_to_src_ROIs"],
            one["info"]["prototypes_similarity_to_src_ROIs"], rtol=1e-5)
        np.testing.assert_allclose(got["vectors"].numpy(),
                                   one["vectors"].numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert (runs["tmp"] / "flagship" / "push_flagship" / "epoch-0" /
            "prototypes_info.pickle").exists()  # rank 0 wrote it


def test_ppnet_push_equals_one_process(runs):
    one = runs["one"]["ppnet"]["push"]
    for r in _ranks(runs, "ppnet"):
        got = r["push"]
        for k in ("bb", "bb_rf", "prototypes_gts"):
            np.testing.assert_array_equal(got["info"][k], one["info"][k])
        np.testing.assert_allclose(got["info"]["prototypes_distances"],
                                   one["info"]["prototypes_distances"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["vectors"].numpy(),
                                   one["vectors"].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_jax_weights_load_onto_the_shards(runs):
    for r in _ranks(runs, "flagship"):
        placed, loaded = r["from_jax"]["placed"], r["from_jax"]["loaded"]
        assert set(placed) == set(loaded)
        for k, v in placed.items():
            assert torch.equal(loaded[k], v), k
        sharded = [k for k, d in r["from_jax"]["plan"].items()
                   if d is not None]
        assert len(sharded) == 3
        assert placed["prototype_vectors"].shape == (dp.P // 2, dp.D)
        assert placed["last_layer.Dense_0.weight"].shape == (dp.K, dp.P // 2)
