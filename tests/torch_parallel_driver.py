"""Ranks of the port's data-parallel tests (``tests/test_torch_port_parallel.py``).

``run_rank`` is the target of each spawned process: it joins a gloo group
through a ``FileStore`` (no TCP port), runs every scenario below on its
rows of the global batches, and writes what it observed to
``<out>/rank<r>.pt``. Only torch and the port are imported here. The
test runs the same scenario functions in its own process, where there is
no group, for the single-process port's results, and computes the JAX
package's itself.
"""

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

P, D, K = 8, 64, 4
CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (P, D, 1, 1, 1),
       "num_classes": K, "img_size": 32, "head_impl": "xla"}
# tests/test_multiprocess.py's criterion (the flagship's terms) and the
# orthogonality term: every term is on, the batch-free ones too
CRITERION = {
    "OrthogonalityLoss": {"loss_weight": 0.01, "mode": "per_class"},
    "CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3,
                      "ab_logitpath": "joined", "reduction": "mean"},
    "ClusterRoiFeat": {"loss_weight": 0.8, "reduction": "mean"},
    "SeparationRoiFeat": {"loss_weight": 0.08, "reduction": "mean"},
    "Lnorm_occurrence": {"p": 2, "loss_weight": 1e-4, "reduction": "mean"},
    "trans_occurrence": {"loss_weight": 0.001, "reduction": "mean"},
    "Lnorm_FC": {"p": 1, "loss_weight": 1e-4},
}
# ProtoPNet at 64x64 (tests/test_torch_port_protopnet_train.py's model)
PPNET = {"name": "ProtoPNet", "base_architecture": "resnet18",
         "prototype_shape": (6, 32, 1, 1), "num_classes": 3, "img_size": 64,
         "add_on_layers_type": "regular",
         "prototype_activation_function": "log"}
PPNET_CRITERION = {"CeLoss": {"loss_weight": 1, "reduction": "mean"},
                   "ClusterPatch": {"loss_weight": 0.8, "reduction": "mean"},
                   "SeparationPatch": {"loss_weight": 0.08,
                                       "reduction": "mean"},
                   "Lnorm_FC": {"p": 1, "loss_weight": 0.0001}}
LR, WD = 1e-4, 1e-3


def global_batch():
    """tests/test_multiprocess.py's 8-sample global batch (seed 17)."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(8, 8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=8).astype(np.int32)
    return x, y, np.ones(8, bool)


def padded_global_batch():
    """Its uneven final batch (seed 23): 6 real samples padded to 8 by
    repeating the last, the padding masked."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(8, 8, 32, 32, 3)).astype(np.float32)
    x[6:] = x[5]
    y = rng.integers(0, 3, size=8).astype(np.int32)
    y[6:] = y[5]
    return x, y, np.array([True] * 6 + [False] * 2)


def image_batch():
    """A padded global batch of 8 images of 64x64 for ProtoPNet."""
    rng = np.random.default_rng(29)
    x = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    x[6:] = x[5]
    y = rng.integers(0, 3, size=8).astype(np.int32)
    y[6:] = y[5]
    return x, y, np.array([True] * 6 + [False] * 2)


def agent_args(csv, save_dir):
    """The tiny flagship trained for one epoch with its push."""
    return ["--config_path=protoasnet_tpu/configs/ours_protoasnet_video.yml",
            f"--save_dir={save_dir}", "--device", "cpu",
            f"--data.data_info_file={csv}", "--data.img_size=32",
            "--data.frames=8", "--data.eval_batch_size=4",
            "--model.prototype_shape=(8, 64, 1, 1, 1)",
            "--model.dtype=float32", "--train.batch_size=2",
            "--train.num_train_epochs=1", "--train.push_start=0",
            "--train.push_rate=1", "--render_prototypes=false"]


def _rows(*arrays, dtype=None):
    """This rank's rows of global numpy arrays, as tensors."""
    from protoasnet_tpu_torch.parallel.mesh import shard_batch

    keys = ("cine", "target_AS", "valid")
    part = shard_batch(dict(zip(keys, arrays)))
    x, y, v = (torch.from_numpy(np.ascontiguousarray(part[k]))
               for k in keys)
    return (x if dtype is None else x.to(dtype)), y.long(), v


def _xprotonet(sd, dtype=torch.float32, every=1, fsdp=False):
    """The tiny flagship with ``sd``'s weights, its optimiser, accumulator
    and steps: {model, opt, acc, train, push, plan}."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    model = build_model(CFG, device="cpu").to(dtype)
    model.load_state_dict(sd)
    plan = None
    if fsdp:
        from protoasnet_tpu_torch.parallel.mesh import (fsdp_param_shardings,
                                                        make_mesh)

        plan = fsdp_param_shardings(model, make_mesh("cpu"),
                                    min_size=1 << 10)
    opt = GroupAdam(model, weight_decay_by_group={g: WD for g in GROUPS})
    acc = GradAccumulator(opt.params, every)
    train, _, push = make_xprotonet_steps(
        model, LossBundle(CRITERION, num_classes=K, abstain_class=True),
        opt, acc)
    return {"model": model, "opt": opt, "acc": acc, "train": train,
            "push": push, "plan": plan}


def _ppnet(dtype=torch.float64):
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_protopnet_steps

    model = build_model(PPNET, device="cpu", seed=3).to(dtype)
    opt = GroupAdam(model, weight_decay_by_group={g: WD for g in GROUPS})
    acc = GradAccumulator(opt.params, 2)  # the gradient stays in .grad
    steps = make_protopnet_steps(
        model, LossBundle(PPNET_CRITERION, num_classes=3,
                          abstain_class=False), opt, acc)
    return model, opt, steps


def _grads(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _lrs():
    from protoasnet_tpu_torch.train.optim import GROUPS

    return {g: LR for g in GROUPS}


def xprotonet_steps(sd, draws):
    """fp32: two chained steps on the global batch, then a fresh step on
    the padded one; the reported (global) losses and logits."""
    train = _xprotonet(sd)["train"]
    x, y, v = _rows(*global_batch())
    m1 = train(x, y, v, _lrs(), affine=draws[0])
    m2 = train(x, y, v, _lrs(), affine=draws[1])
    mp = _xprotonet(sd)["train"](*_rows(*padded_global_batch()), _lrs(),
                                 affine=draws[0])
    return {"loss": float(m1["loss_all"]), "loss2": float(m2["loss_all"]),
            "pad_loss": float(mp["loss_all"]),
            "logits": m1["logits"].clone()}


def _adam_state(opt):
    return {i: {k: v.clone() for k, v in s.items()}
            for i, s in opt.state_dict()["state"].items()}


def fsdp_step(sd, draws):
    """fp32: the first step under FSDP2, its optimiser's state, and the
    data-parallel optimiser's state loaded into a fresh FSDP2 one and
    saved again."""
    run = _xprotonet(sd, fsdp=True)
    m = run["train"](*_rows(*global_batch()), _lrs(), affine=draws[0])
    dp = _xprotonet(sd)
    dp["train"](*_rows(*global_batch()), _lrs(), affine=draws[0])
    again = _xprotonet(sd, fsdp=True)["opt"]
    again.load_state_dict(dp["opt"].state_dict())
    return {"loss": float(m["loss_all"]), "plan": run["plan"],
            "adam": _adam_state(run["opt"]), "dp_adam": _adam_state(dp["opt"]),
            "reloaded": _adam_state(again)}


def float64_step(sd, draws):
    """float64 on the padded batch: one micro-step of an accumulation of
    two, its gradient as the accumulator saves it (the global batch's),
    the BN running statistics it wrote; that state loaded into a fresh
    accumulator before a second micro-step, which updates (a resumed run);
    the parameters after a step that updates at once."""
    x, y, v = _rows(*padded_global_batch(), dtype=torch.float64)
    run = _xprotonet(sd, torch.float64, 2)
    m = run["train"](x, y, v, _lrs(), affine=draws[0])
    saved = run["acc"].state_dict()
    out = {"loss": float(m["loss_all"]), "saved": saved,
           "state": _state(run["model"])}
    run = _xprotonet(sd, torch.float64, 2)
    run["acc"].load_state_dict(saved)
    run["train"](x, y, v, _lrs(), affine=draws[0])
    out["resumed"] = _state(run["model"])
    run = _xprotonet(sd, torch.float64, 1)
    run["train"](x, y, v, _lrs(), affine=draws[0])
    out["after"] = _state(run["model"])
    return out


def ppnet_step():
    """float64 ProtoPNet (the L2 head): summed gradient and terms."""
    from protoasnet_tpu_torch.parallel.mesh import sync_grads

    model, opt, (train_step, _, _) = _ppnet()
    x, y, v = _rows(*image_batch(), dtype=torch.float64)
    m = train_step(x, y, v, _lrs())
    sync_grads(opt.params)
    return {"terms": {k: float(t) for k, t in m.items()
                      if k.startswith("loss")},
            "grads": _grads(model), "state": _state(model)}


def push(sd, csv, root):
    """The XProtoNet push over the train split's push loader."""
    from protoasnet_tpu_torch.data.dataset import get_as_dataloader
    from protoasnet_tpu_torch.models.layers import prototype_class_identity
    from protoasnet_tpu_torch.push.push import push_prototypes

    run = _xprotonet(sd)
    cfg = {"data_info_file": csv, "batch_size": 4, "push_batch_size": 4,
           "frames": 8, "img_size": 32, "iterate_intervals": False}
    loader = get_as_dataloader(cfg, "train", "push", seed=0, device="cpu")
    vectors, info = push_prototypes(
        loader, run["push"], run["model"].prototype_vectors,
        class_identity=prototype_class_identity(P, K),
        root_dir_for_saving_prototypes=root, epoch_number=0, render=False)
    return {"vectors": vectors, "info": info}


def agent_epoch(csv, save_dir):
    from protoasnet_tpu_torch.main import main

    main(agent_args(csv, save_dir))
    return {}


def explain(csv, save_dir):
    """The explain entry point on the trained run under ``save_dir``."""
    from protoasnet_tpu_torch.explain.__main__ import main

    main(agent_args(csv, save_dir) + ["--explain_locally=true",
                                      "--eval_data_type=test"])
    return {}


def run_rank(rank, world, store, out, inputs):
    """One rank: join the group, run every scenario, save the results."""
    os.environ.pop("WORLD_SIZE", None)
    os.environ.pop("MASTER_ADDR", None)
    torch.set_num_threads(1)  # conv3d's backward takes another path at >1
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        sd, draws = torch.load(inputs["weights"]), inputs["draws"]
        res = {"xprotonet": xprotonet_steps(sd, draws),
               "fsdp": fsdp_step(sd, draws),
               "float64": float64_step(sd, draws),
               "ppnet": ppnet_step(),
               "push": push(sd, inputs["csv"], inputs["push_root"]),
               "agent": agent_epoch(inputs["csv"], inputs["agent_dir"]),
               "explain": explain(inputs["csv"], inputs["agent_dir"])}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.destroy_process_group()
