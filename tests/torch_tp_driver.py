"""Ranks of the port's prototype tensor-parallel tests
(``tests/test_torch_port_tensor_parallel.py``).

``run_rank`` is the target of each spawned process: it joins a gloo group
through a ``FileStore``, makes the 2-D (data, model) mesh of its scenario,
runs it on its rows of the global batches with its block of the
prototypes, and writes what it observed, made whole, to
``<out>/rank<r>.pt``. The same scenario functions run in the test's own
process without a group (``mesh`` None): the single-process port. Only
torch, numpy and the port are imported here.

Scenarios:

* ``"flagship"`` (2 x 2): the tiny flagship of ``torch_parallel_driver``
  (8 frames of 32x32, P=8, D=64, K=4, two prototypes a model rank of its
  two classes): the fp32 step-1 loss, logits and similarities; in float64
  one micro-step of an accumulation of two (the accumulator's saved
  gradient, the BN running statistics), then a step that updates (the
  parameters after it, Adam's state saved whole, loaded onto fresh shards
  and saved again); the JAX weights loaded onto the shards; the push;
* ``"image"`` (1 x 2): the image XProtoNet with P=6, K=3 (two prototypes a
  class, three a rank: class 1 straddles the ranks), fp32 loss, float64
  gradients and BN statistics;
* ``"ppnet"`` (1 x 2): ProtoPNet with P=6, K=3 (the L2 head at P/m=3), the
  same, and its patch push.
"""

import os
import sys
import traceback

import torch
import torch.distributed as dist

import torch_parallel_driver as dp

IMAGE = {"name": "XProtoNet", "base_architecture": "resnet18",
         "prototype_shape": (6, 32, 1, 1), "num_classes": 3, "img_size": 64,
         "head_impl": "xla"}
PPNET = dict(dp.PPNET, head_impl="xla")
MESHES = {"flagship": (2, 2), "image": (1, 2), "ppnet": (1, 2)}


def image_batch():
    """``torch_parallel_driver.image_batch`` with labels of the image
    XProtoNet's two classes (its third is the abstain class)."""
    x, y, v = dp.image_batch()
    return x, y % 2, v


def _lrs():
    from protoasnet_tpu_torch.train.optim import GROUPS

    return {g: dp.LR for g in GROUPS}


def _model(cfg, jax_vars, dtype, mesh):
    """``cfg``'s model with the JAX weights, sharded over ``mesh``'s
    ``model`` axis first when there is a mesh (the full JAX arrays loaded
    onto the shards)."""
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.models.from_jax import load_jax_variables
    from protoasnet_tpu_torch.parallel.mesh import prototype_param_shardings

    model = build_model(cfg, device="cpu").to(dtype)
    if mesh is not None:
        prototype_param_shardings(model, mesh)
    return load_jax_variables(model, *jax_vars).to(dtype)


def _steps(model, criterion, k, every, protopnet=False):
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import (make_protopnet_steps,
                                                  make_xprotonet_steps)

    opt = GroupAdam(model, weight_decay_by_group={g: dp.WD for g in GROUPS})
    acc = GradAccumulator(opt.params, every)
    make = make_protopnet_steps if protopnet else make_xprotonet_steps
    train, _, push = make(model, LossBundle(criterion, num_classes=k,
                                            abstain_class=not protopnet),
                          opt, acc)
    return opt, acc, train, push


def whole_state(model):
    """The model's state_dict with every prototype block gathered over
    ``model``: the single-process layout."""
    from protoasnet_tpu_torch.parallel.mesh import gather_shard

    params = dict(model.named_parameters())
    return {k: (gather_shard(v, params[k]) if k in params else v
                ).detach().clone() for k, v in model.state_dict().items()}


def _adam(opt):
    return {i: {k: v.clone() for k, v in s.items()}
            for i, s in opt.state_dict()["state"].items()}


def _train_kw(protopnet, draw):
    return {} if protopnet else {"affine": draw}


def step_scenario(cfg, criterion, k, batch, jax_vars, draw, mesh,
                  protopnet=False):
    """fp32 step 1 (reported loss, logits, whole similarities or
    distances); float64: the accumulator's saved gradient after one
    micro-step of two and the BN statistics it wrote, the parameters after
    a step that updates, Adam's state saved whole and saved again after a
    load onto fresh shards, and the rank's own Adam moments after that
    load."""
    rows = dp._rows(*batch)
    model = _model(cfg, jax_vars, torch.float32, mesh)
    _, _, train, _ = _steps(model, criterion, k, 1, protopnet)
    m = train(*rows, _lrs(), **_train_kw(protopnet, draw))
    out = {"loss": float(m["loss_all"]), "logits": m["logits"].clone(),
           "whole": m["min_distances" if protopnet else
                      "similarities"].clone()}
    rows = dp._rows(*batch, dtype=torch.float64)
    model = _model(cfg, jax_vars, torch.float64, mesh)
    _, acc, train, _ = _steps(model, criterion, k, 2, protopnet)
    m = train(*rows, _lrs(), **_train_kw(protopnet, draw))
    out.update(loss64=float(m["loss_all"]), saved=acc.state_dict(),
               state=whole_state(model))
    model = _model(cfg, jax_vars, torch.float64, mesh)
    opt, _, train, _ = _steps(model, criterion, k, 1, protopnet)
    train(*rows, _lrs(), **_train_kw(protopnet, draw))
    out.update(after=whole_state(model), adam=_adam(opt))
    again = _model(cfg, jax_vars, torch.float64, mesh)
    opt2 = _steps(again, criterion, k, 1, protopnet)[0]
    opt2.load_state_dict(opt.state_dict())
    out["reloaded"] = _adam(opt2)
    order = [p for g in opt2.optimizer.param_groups for p in g["params"]]
    out["local_moments"] = {i: opt2.optimizer.state[p]["exp_avg"].clone()
                            for i, p in enumerate(order)}
    return out


def flagship_push(jax_vars, csv, root, mesh):
    """The XProtoNet push of the tiny flagship over the train split."""
    from protoasnet_tpu_torch.data.dataset import get_as_dataloader
    from protoasnet_tpu_torch.models.layers import prototype_class_identity
    from protoasnet_tpu_torch.parallel.mesh import gather_shard
    from protoasnet_tpu_torch.push.push import push_prototypes

    model = _model(dp.CFG, jax_vars, torch.float32, mesh)
    push = _steps(model, dp.CRITERION, dp.K, 1)[3]
    cfg = {"data_info_file": csv, "batch_size": 4, "push_batch_size": 4,
           "frames": 8, "img_size": 32, "iterate_intervals": False}
    loader = get_as_dataloader(cfg, "train", "push", seed=0, device="cpu")
    vectors, info = push_prototypes(
        loader, push, model.prototype_vectors,
        class_identity=prototype_class_identity(dp.P, dp.K),
        root_dir_for_saving_prototypes=root, epoch_number=0, render=False)
    return {"vectors": gather_shard(vectors, model.prototype_vectors),
            "info": info}


def ppnet_push(jax_vars, mesh):
    """ProtoPNet's patch push over the image batch, one hand-made batch."""
    from protoasnet_tpu_torch.models.layers import prototype_class_identity
    from protoasnet_tpu_torch.parallel.mesh import gather_shard
    from protoasnet_tpu_torch.push.push_protopnet import \
        push_prototypes_patch

    model = _model(PPNET, jax_vars, torch.float32, mesh)
    push = _steps(model, dp.PPNET_CRITERION, 3, 1, protopnet=True)[3]
    x, y, v = dp.image_batch()
    loader = [{"cine": torch.from_numpy(x), "target_AS": y, "valid": v}]
    vectors, info = push_prototypes_patch(
        loader, push, model, prototype_class_identity(6, 3), img_size=64,
        render=False)
    return {"vectors": gather_shard(vectors, model.prototype_vectors),
            "info": info}


def placed_from_jax(jax_vars, mesh):
    """The flagship's JAX weights loaded onto its shards, beside the full
    weights placed by ``prototype_param_shardings``."""
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.models.from_jax import load_jax_variables
    from protoasnet_tpu_torch.parallel.mesh import prototype_param_shardings

    full = load_jax_variables(build_model(dp.CFG, device="cpu"), *jax_vars)
    plan = prototype_param_shardings(full, mesh)
    return {"plan": plan, "placed": dict(full.state_dict()),
            "loaded": dict(_model(dp.CFG, jax_vars, torch.float32,
                                  mesh).state_dict())}


def scenario(name, inputs, mesh=None):
    """One scenario's results; ``mesh`` None in one process."""
    jv = inputs["jax"][name]
    if name == "flagship":
        out = step_scenario(dp.CFG, dp.CRITERION, dp.K,
                            dp.padded_global_batch(), jv, inputs["draw"],
                            mesh)
        out["push"] = flagship_push(jv, inputs["csv"], inputs["push_root"],
                                    mesh)
        if mesh is not None:
            out["from_jax"] = placed_from_jax(jv, mesh)
        return out
    if name == "image":
        return step_scenario(IMAGE, dp.CRITERION, 3, image_batch(), jv,
                             inputs["draw"], mesh)
    out = step_scenario(PPNET, dp.PPNET_CRITERION, 3, dp.image_batch(), jv,
                        None, mesh, protopnet=True)
    out["push"] = ppnet_push(jv, mesh)
    return out


def run_rank(rank, world, store, out, names, inputs):
    """One rank: join the group, make the mesh, run ``names``, save."""
    from protoasnet_tpu_torch.parallel.mesh import (make_mesh_2d,
                                                    shutdown_distributed)

    os.environ.pop("WORLD_SIZE", None)
    os.environ.pop("MASTER_ADDR", None)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(inputs, weights_only=False)
        mesh = make_mesh_2d(*MESHES[names[0]])
        res = {"mesh": (mesh.data_rank, mesh.model_rank)}
        for name in names:
            res[name] = scenario(name, dict(
                inputs, push_root=os.path.join(out, f"push_{name}")), mesh)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        shutdown_distributed()
