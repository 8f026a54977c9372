"""Train / evaluate / push entry point of the port.

    python -m protoasnet_tpu_torch.main \
        --config_path=protoasnet_tpu/configs/ours_protoasnet_video.yml \
        --save_dir=logs [--run_name=...] [--device cpu] \
        [--eval_only=true --eval_data_type=test] [--push_only=true] \
        [--model.checkpoint_path=...] [--any.nested.key=value]

The flags of the JAX package's ``main.py``. It runs on CUDA unless
``--device cpu`` is given, and raises when there is no card and no such
request. The run directory is ``<save_dir>/<run_name>`` (reused, and the
run resumed, when it holds a checkpoint).

Data-parallel over N cards, one process each (``parallel/mesh.py``)::

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m protoasnet_tpu_torch.main --config_path=... [--any.key=value]

The process group is joined first thing (NCCL on the cards, gloo with
``--device cpu``) and torn down on exit; rank 0 picks and writes the run
directory, the logs and the config dump.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None):
    """Run the command line ``argv`` (default ``sys.argv[1:]``); returns
    the agent."""
    from protoasnet_tpu_torch.parallel.mesh import joined_group
    from protoasnet_tpu_torch.utils.config import updated_config
    from protoasnet_tpu_torch.utils.device import resolve_device

    config = updated_config(argv)
    # no card, no CPU request: raise
    with joined_group(resolve_device(config.get("device"))):
        return _run(config)


def _run(config):
    from protoasnet_tpu_torch.parallel.mesh import is_main
    from protoasnet_tpu_torch.utils.run import backup_code, open_run, set_seed

    run_type = "train"
    if config.get("eval_only"):
        run_type = f"eval_{config.get('eval_data_type', 'val')}"
    elif config.get("push_only"):
        run_type = "push"
    save_dir = open_run(config, run_type)
    if run_type == "train" and is_main():
        backup_code(save_dir)
    set_seed(int(config["train"].get("seed", 0)))

    from protoasnet_tpu_torch.train.agents import build_agent

    agent = build_agent(config)
    if config.get("eval_only"):
        agent.evaluate(mode=config.get("eval_data_type", "val"))
    elif config.get("push_only"):
        agent.push(replace_prototypes=False)
    else:
        agent.run()
        logging.info("evaluating the final model on val")
        agent.evaluate(mode="val")
    agent.finalize()
    return agent


if __name__ == "__main__":
    main()
