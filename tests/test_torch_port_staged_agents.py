"""The port's staged and ProtoPNet agents through its training entry point
on the CPU, at a tiny size (64x64 images of the synthetic fixture, small
prototype shapes, train batch 4 with accumulation 2, two epochs: warm, then
joint with a push at epoch 1).

- ``python -m protoasnet_tpu_torch.main --device cpu`` trains
  ``baseline_protopnet.yml`` (``ProtoPNet_Base``): warm -> joint -> push ->
  the two last-layer epochs, writing ``bb.npy``,
  ``bb-receptive_field.npy``, ``prototypes_info.pickle``, the prototype
  pictures and the three stages' optimiser and accumulator states; two
  seeded runs are equal bit for bit and a rerun on the same directory
  resumes from ``last.ckpt``;
- ``baseline_protopnet_e2e.yml`` (``ProtoPNet_e2e``), ``XProtoNet_Base``
  (the image ProtoASNet config with the agent overridden) and one epoch of
  ``ours_protoasnet_image.yml`` (``XProtoNet_e2e``, frames=1, bf16);
- each stage moves only its groups (warm: the add-on and prototypes, not
  the trunk; last: only the readout);
- the stage learning rates equal the JAX agents' ``stage_lrs``;
- ``StageOptimizers`` keeps each stage's partial accumulation apart across
  stage switches and through a checkpoint taken right after a warm ->
  joint and a joint -> last switch.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.main import main
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.train.agents import AGENTS, build_agent
from protoasnet_tpu_torch.train.optim import (GroupAdam, StageOptimizers,
                                              group_of)
from protoasnet_tpu_torch.utils.config import updated_config
from protoasnet_tpu_torch.utils.io import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "protoasnet_tpu" / "configs"
AGENT_NAMES = ("Video_XProtoNet_e2e", "XProtoNet_e2e", "XProtoNet_Base",
               "ProtoPNet_Base", "ProtoPNet_e2e")


def _args(config, csv, save_dir, *extra, epochs=2):
    return [f"--config_path={CONFIGS / config}", f"--save_dir={save_dir}",
            "--device", "cpu", f"--data.data_info_file={csv}",
            "--data.img_size=64", "--data.eval_batch_size=16",
            "--data.num_workers=1", "--train.batch_size=4",
            "--train.accumulation_steps=2",
            f"--train.num_train_epochs={epochs}",
            "--train.num_warm_epochs=1", "--train.push_start=1",
            "--train.push_rate=1", *extra]


PPNET = ("baseline_protopnet.yml", "--model.prototype_shape=(6, 32, 1, 1)")
XBASE = ("ours_protoasnet_image.yml", "--agent=XProtoNet_Base",
         "--model.prototype_shape=(8, 32, 1, 1)", "--model.dtype=float32",
         "--train.optimizer.joint_lrs.cnn_backbone=0.0001",
         "--train.optimizer.joint_lrs.add_on_layers=0.003",
         "--train.optimizer.joint_lrs.occurrence_module=0.003",
         "--train.optimizer.joint_lrs.prototype_vectors=0.003",
         "--train.optimizer.warm_lrs.add_on_layers=0.003",
         "--train.optimizer.warm_lrs.prototype_vectors=0.003",
         "--train.optimizer.last_layer_lr=0.0001")


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")),
                                  num_videos=12, seed=3)


@pytest.fixture(scope="module")
def ppnet_runs(csv, tmp_path_factory):
    """The staged ProtoPNet: once through the command line, once in this
    process with the same seed."""
    root = tmp_path_factory.mktemp("ppnet")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    cli = subprocess.run(
        [sys.executable, "-m", "protoasnet_tpu_torch.main",
         *_args(PPNET[0], csv, root / "a", *PPNET[1:])], cwd=str(REPO),
        env=env, capture_output=True, text=True, timeout=600)
    assert cli.returncode == 0, cli.stderr[-4000:]
    torch.set_num_threads(2)
    agent = main(_args(PPNET[0], csv, root / "b", *PPNET[1:]))
    return dict(root=root, a=root / "a" / "baseline_protopnet",
                b=root / "b" / "baseline_protopnet", agent=agent)


def test_registry_has_every_agent_name():
    assert set(AGENTS) == set(AGENT_NAMES)
    with pytest.raises(ValueError, match="Unknown agent"):
        build_agent({"agent": "ProtoPNet_Staged"})


def test_protopnet_staged_cli_writes_the_push_and_stage_states(ppnet_runs):
    run = ppnet_runs["a"]
    push = run / "img" / "epoch-1_pushed"
    for name in ("bb.npy", "bb-receptive_field.npy",
                 "prototypes_info.pickle"):
        assert (push / name).exists(), name
    bb = np.load(push / "bb.npy")
    assert bb.shape == (6, 5) and (bb[:, 0] < 8).all()  # 8 training images
    assert len(list(push.glob("prototype-img*.png"))) == 6
    ckpt = load_checkpoint(str(run / "last.ckpt"))
    assert set(ckpt) == {
        "epoch", "iteration", "model", "scheduler_joint", "best_metric",
        *(f"{k}_{s}" for k in ("optimizer", "accumulator")
          for s in ("warm", "joint", "last"))}
    # 8 images at batch 4: two micro-steps and one Adam step an epoch;
    # warm, joint and the two last-layer epochs
    assert ckpt["iteration"] == 8
    for stage, steps in (("warm", 1), ("joint", 1), ("last", 2)):
        state = ckpt[f"optimizer_{stage}"]["state"]
        assert {float(s["step"]) for s in state.values()} == {steps}, stage
    assert ckpt["scheduler_joint"]["epochs"] == 1  # StepLR after joint only
    assert "csv_val_push" in os.listdir(run)


def test_protopnet_two_seeded_runs_are_equal(ppnet_runs):
    a = load_checkpoint(str(ppnet_runs["a"] / "last.ckpt"))
    b = load_checkpoint(str(ppnet_runs["b"] / "last.ckpt"))
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    np.testing.assert_array_equal(
        np.load(ppnet_runs["a"] / "img" / "epoch-1_pushed" / "bb.npy"),
        np.load(ppnet_runs["b"] / "img" / "epoch-1_pushed" / "bb.npy"))


def test_protopnet_resumes_from_last_checkpoint(ppnet_runs, csv):
    agent = main(_args(PPNET[0], csv, ppnet_runs["root"] / "b", *PPNET[1:],
                       epochs=3))
    ckpt = load_checkpoint(str(ppnet_runs["b"] / "last.ckpt"))
    assert ckpt["epoch"] == 2
    assert ckpt["iteration"] > ppnet_runs["agent"].current_iteration
    assert agent.stages.active in ("joint", "last")
    assert "auto-resume from" in (ppnet_runs["b"] / "info_train.log"
                                  ).read_text()


def _moved(agent, init):
    """The parameter groups whose values differ from ``init``."""
    return {group_of(k) for k, v in agent.model.named_parameters()
            if not torch.equal(v.detach().cpu(), init[k])}


@pytest.mark.parametrize("agent_cfg", [PPNET, XBASE],
                         ids=["ProtoPNet_Base", "XProtoNet_Base"])
def test_each_stage_moves_only_its_groups(agent_cfg, csv, tmp_path):
    """One warm epoch moves the add-on and prototypes and not the trunk or
    the readout; a last-layer epoch moves only the readout."""
    torch.set_num_threads(2)
    config = updated_config(_args(agent_cfg[0], csv, tmp_path,
                                  *agent_cfg[1:]))
    config["save_dir"] = str(tmp_path)
    agent = build_agent(config)
    init = {k: v.detach().clone()
            for k, v in agent.model.named_parameters()}
    agent._train_epoch(0, "warm")
    warm = {"add_on", "prototypes"} | (
        {"occurrence"} if agent_cfg is XBASE else set())
    assert _moved(agent, init) == warm
    init = {k: v.detach().clone()
            for k, v in agent.model.named_parameters()}
    agent._train_epoch(0, "last")
    assert _moved(agent, init) == {"last_layer"}


def test_protopnet_e2e_trains(csv, tmp_path):
    torch.set_num_threads(2)
    agent = main(_args("baseline_protopnet_e2e.yml", csv, tmp_path,
                       "--model.prototype_shape=(6, 32, 1, 1)"))
    run = Path(agent.save_dir)
    assert (run / "img" / "epoch-1_pushed" / "bb.npy").exists()
    ckpt = load_checkpoint(str(run / "last.ckpt"))
    assert {float(s["step"]) for s in
            ckpt["optimizer"]["state"].values()} == {2.0}


def test_xprotonet_staged_trains(csv, tmp_path):
    torch.set_num_threads(2)
    agent = main(_args(XBASE[0], csv, tmp_path, *XBASE[1:]))
    run = Path(agent.save_dir)
    assert (run / "img" / "epoch-1_pushed" / "prototypes_info.pickle"
            ).exists()
    ckpt = load_checkpoint(str(run / "last.ckpt"))
    # warm, joint and five last-layer epochs of one Adam step each
    assert ckpt["iteration"] == 14
    for stage, steps in (("warm", 1), ("joint", 1), ("last", 5)):
        state = ckpt[f"optimizer_{stage}"]["state"]
        assert {float(s["step"]) for s in state.values()} == {steps}, stage
    assert {"scheduler_joint", "scheduler_last"} <= set(ckpt)


def test_image_protoasnet_trains_one_epoch(csv, tmp_path):
    """``ours_protoasnet_image.yml`` as shipped (``XProtoNet_e2e``,
    frames=1, bf16) through the rank-4 path, with a push."""
    torch.set_num_threads(2)
    agent = main(_args("ours_protoasnet_image.yml", csv, tmp_path,
                       "--model.prototype_shape=(8, 32, 1, 1)",
                       "--train.num_warm_epochs=0", "--train.push_start=0",
                       epochs=1))
    assert agent.model.dtype == torch.bfloat16
    run = Path(agent.save_dir)
    push = run / "img" / "epoch-0_pushed"
    assert (push / "prototypes_info.pickle").exists()
    assert len(list(push.glob("*.png"))) == 8
    ckpt = load_checkpoint(str(run / "last.ckpt"))
    assert {float(s["step"]) for s in
            ckpt["optimizer"]["state"].values()} == {1.0}


@pytest.fixture(scope="module")
def jax_stage_lrs(csv, tmp_path_factory):
    """The JAX agents' ``stage_lrs`` for the same configs."""
    from protoasnet_tpu.train.agents import build_agent as jax_build_agent
    from protoasnet_tpu.utils.config import updated_config as jax_config

    out = {}
    for name, cfg in (("ProtoPNet_Base", PPNET), ("XProtoNet_Base", XBASE)):
        root = tmp_path_factory.mktemp(name)
        argv = [a for a in _args(cfg[0], csv, root, *cfg[1:])
                if a not in ("--device", "cpu")]
        out[name] = jax_build_agent(jax_config(argv)).stage_lrs
    return out


@pytest.mark.parametrize("name", ["ProtoPNet_Base", "XProtoNet_Base"])
def test_stage_lrs_equal_the_jax_agents(name, jax_stage_lrs, csv, tmp_path):
    cfg = PPNET if name == "ProtoPNet_Base" else XBASE
    config = updated_config(_args(cfg[0], csv, tmp_path, *cfg[1:]))
    config["save_dir"] = str(tmp_path)
    agent = build_agent(config)
    assert agent.stage_lrs == jax_stage_lrs[name]


def test_stage_switches_keep_partial_sums_through_a_checkpoint():
    """Accumulation 2 over warm (1 micro-step) -> joint (1) -> last (1):
    each switch parks the partial sum; a checkpoint right after each
    switch restores it, so the resumed run's next steps equal the
    uninterrupted run's."""
    cfg = {"name": "ProtoPNet", "base_architecture": "resnet18",
           "prototype_shape": (4, 16, 1, 1), "num_classes": 3,
           "img_size": 32, "add_on_layers_type": "regular"}
    rng = np.random.default_rng(0)
    grads = [{k: torch.from_numpy(rng.normal(size=tuple(v.shape)))
              .float() for k, v in build_model(cfg, device="cpu")
              .named_parameters()} for _ in range(5)]
    lrs = {g: 1e-3 for g in ("backbone", "add_on", "occurrence",
                             "prototypes", "last_layer")}
    # (stage, micro-gradient) in order; a checkpoint after the 2nd and 3rd
    plan = [("warm", 0), ("joint", 1), ("last", 2), ("warm", 3),
            ("joint", 4)]

    def run(resume_at=()):
        model = build_model(cfg, device="cpu", seed=1)
        stages = StageOptimizers(model, {"backbone": 1e-3}, every=2)
        for i, (stage, gi) in enumerate(plan):
            if i in resume_at:  # save, then load into a fresh set
                state = copy.deepcopy(stages.state_dict())
                sd = copy.deepcopy(model.state_dict())
                model = build_model(cfg, device="cpu", seed=5)
                model.load_state_dict(sd)
                stages = StageOptimizers(model, {"backbone": 1e-3}, every=2)
                stages.load_state_dict(state)
            stages.activate(stage)
            for k, p in model.named_parameters():
                p.grad = grads[gi][k].clone() if p.grad is None \
                    else p.grad + grads[gi][k]
            if stages.accumulators[stage].micro_step():
                stages.optimizers[stage].step(lrs, stage)
                stages.optimizers[stage].zero_grad()
        return model

    ref = run()
    got = run(resume_at=(1, 2))
    for (k, a), b in zip(ref.named_parameters(), got.parameters()):
        assert torch.equal(a, b), k
    # what that must be: warm's step on micro-gradients 0 + 3, then
    # joint's on 1 + 4; last's single micro-step never steps
    want = build_model(cfg, device="cpu", seed=1)
    for stage, (g1, g2) in (("warm", (0, 3)), ("joint", (1, 4))):
        opt = GroupAdam(want, {"backbone": 1e-3})
        for k, p in want.named_parameters():
            p.grad = grads[g1][k] + grads[g2][k]
        opt.step(lrs, stage)
    for (k, a), b in zip(ref.named_parameters(), want.parameters()):
        assert torch.equal(a, b), k
