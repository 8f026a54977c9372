"""The JAX package's agents at the port's small test sizes, shared by the
port's tests that hold the port against a JAX run (checkpoints, export,
live serving, trackers).

A plain module, not a test module: importing it changes no process-wide
state (no thread count, no environment), so any test module may import
it in any order.
"""

import os

import jax.numpy as jnp
import numpy as np

from protoasnet_tpu.train.agents import build_agent as jax_build_agent
from protoasnet_tpu_torch.utils.config import updated_config

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "protoasnet_tpu", "configs")
LR_A, LR_B = 2.0 ** -13, 2.0 ** -9  # exact in float32

# the agents at the port's small test sizes: video 8x32^2, P=8, D=64;
# 2-D at 64^2
_COMMON = ("--model.pretrained=false", "--model.head_impl=xla",
           "--model.dtype=float32", "--train.accumulation_steps=2",
           "--train.batch_size=2", "--data.num_workers=1",
           "--data.eval_batch_size=8", "--train.num_warm_epochs=1")
AGENTS = {
    "Video_XProtoNet_e2e": ("ours_protoasnet_video.yml", (
        "--data.img_size=32", "--data.frames=8",
        "--model.prototype_shape=(8, 64, 1, 1, 1)",
        f"--train.optimizer.lr_same={LR_A}")),
    "XProtoNet_Base": ("ours_protoasnet_image.yml", (
        "--agent=XProtoNet_Base", "--data.img_size=64",
        "--model.prototype_shape=(8, 32, 1, 1)",
        *(f"--train.optimizer.joint_lrs.{g}={lr}" for g, lr in (
            ("cnn_backbone", LR_A), ("add_on_layers", LR_B),
            ("occurrence_module", LR_B), ("prototype_vectors", LR_B))),
        f"--train.optimizer.warm_lrs.add_on_layers={LR_B}",
        f"--train.optimizer.warm_lrs.prototype_vectors={LR_B}",
        f"--train.optimizer.last_layer_lr={LR_A}")),
    "ProtoPNet_Base": ("baseline_protopnet.yml", (
        "--data.img_size=64", "--model.prototype_shape=(6, 32, 1, 1)",
        *(f"--train.optimizer.joint_lrs.{g}={lr}" for g, lr in (
            ("features", LR_A), ("add_on_layers", LR_B),
            ("prototype_vectors", LR_B))),
        f"--train.optimizer.warm_lrs.add_on_layers={LR_B}",
        f"--train.optimizer.warm_lrs.prototype_vectors={LR_B}",
        f"--train.optimizer.last_layer_lr={LR_A}")),
    "ProtoPNet_e2e": ("baseline_protopnet_e2e.yml", (
        "--data.img_size=64", "--model.prototype_shape=(6, 32, 1, 1)",
        f"--train.optimizer.lr_same={LR_A}")),
}
STAGED = {"XProtoNet_Base", "ProtoPNet_Base"}
PPNETS = {"ProtoPNet_Base", "ProtoPNet_e2e"}


def agent_config(name, csv, save_dir, *extra):
    """The config both packages' agents take (the port's own keys, such
    as ``device``, are ignored by the JAX package)."""
    cfg_file, args = AGENTS[name]
    cfg = updated_config([f"--config_path={os.path.join(CONFIGS, cfg_file)}",
                          f"--save_dir={save_dir}",
                          f"--data.data_info_file={csv}", *_COMMON, *args,
                          *extra])
    cfg["device"] = "cpu"
    return cfg


def sample_batch(name, seed, n=2):
    rng = np.random.default_rng(seed)
    shape = (n, 8, 32, 32, 3) if name == "Video_XProtoNet_e2e" else \
        (n, 64, 64, 3)
    y = rng.integers(0, 3, size=n).astype(np.int32)
    return rng.normal(size=shape), y, np.ones(n, bool)


def _mark_trained(agent, name):
    """Distinct epoch, iteration, best metric and lr scales, so that the
    port must carry each across."""
    agent.current_epoch, agent.current_iteration = 2, 7
    agent.best_metric = 0.375
    if name == "XProtoNet_Base":
        agent.schedulers["joint"].lr, agent.schedulers["last"].lr = 0.5, 0.25
    else:
        agent.scheduler.lr = 0.5


def _jax_run(name, csv, run):
    """The JAX agent ``name`` at fp32, marked trained, its checkpoint
    saved by its own ``save_checkpoint`` into ``run`` (with
    ``config_agent.yml``)."""
    agent = jax_build_agent(agent_config(name, csv, str(run)))
    _mark_trained(agent, name)
    agent.save_checkpoint()
    return agent


def _jax_logits(agent, x):
    return np.asarray(agent.model.apply(
        {"params": agent.params, "batch_stats": agent.batch_stats},
        jnp.asarray(x, jnp.float32), train=False)[0])
